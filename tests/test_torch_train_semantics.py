"""Training semantics the JAX parity step (tests/test_torch_train_step.py)
switches off, each against its own statement: matching augmentation from
given uniforms (a numpy statement of repdepth.py:251-267), drop path
(per-sample mask, 1/keep scaling, the linspace schedule per block),
activation checkpointing (also under --grad_accum 2), a bf16 step, and
the StepLR schedule. No JAX compile: a file of its own, so it runs
beside the parity step."""

import numpy as np
import pytest
import torch

from ppeadepth_tpu_torch.models import RepDepth, init_weights
from ppeadepth_tpu_torch.models.blocks import DropPath
from ppeadepth_tpu_torch.models.repdepth import matching_augmentation
from ppeadepth_tpu_torch.models.replknet import REPLK_CONFIGS, RepLKNet
from ppeadepth_tpu_torch.train.schedule import make_optimizer, step_lr_factor
from ppeadepth_tpu_torch.train.step import (
    create_train_state, draw, make_train_step)
from tests.test_train_step import make_batch
from tests.torch_parity import TINY
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

OPT = TINY.replace(drop_path_rate=0.0, no_matching_augmentation=True)
B = 2
LR = 1e-4


def _grads(model):
    return {n: p.grad.numpy() for n, p in model.named_parameters()
            if p.requires_grad}


def _np_matching_augmentation(u, current, lookup, rel_poses):
    """repdepth.py:251-267 in numpy."""
    static = u < 0.25
    zero = (u >= 0.25) & (u < 0.5)
    lookup = np.where(static[:, None, None, None, None], current[:, None], lookup)
    rel_poses = np.where(zero[:, None, None, None], 0.0, rel_poses)
    return lookup, rel_poses, (static | zero).astype(np.float32).reshape(-1, 1, 1, 1)


def test_matching_augmentation_matches_numpy():
    rng = np.random.RandomState(0)
    u = np.array([0.1, 0.25, 0.3, 0.49, 0.5, 0.9], np.float32)
    n = len(u)
    current = rng.rand(n, 3, 4, 5).astype(np.float32)
    lookup = rng.rand(n, 2, 3, 4, 5).astype(np.float32)
    poses = rng.rand(n, 2, 4, 4).astype(np.float32)
    got = matching_augmentation(*(torch.from_numpy(a) for a in (u, current, lookup, poses)))
    for g, r in zip(got, _np_matching_augmentation(u, current, lookup, poses)):
        np.testing.assert_array_equal(g.numpy(), r)
    np.testing.assert_array_equal(got[2].numpy().ravel(), [1, 1, 1, 1, 0, 0])


def test_drop_path_semantics():
    """Per-sample mask of 0 or 1/keep, drawn from the given generator,
    identity in eval mode or at rate 0, and the linspace schedule shared
    by the two blocks of each pair (replknet.py:359)."""
    dp = DropPath(0.3).train()
    x = torch.ones(4000, 2, 3, 5)
    mask = dp.draw(x, torch.Generator().manual_seed(0))
    assert mask.shape == (4000, 1, 1, 1)
    assert set(np.unique(mask.numpy()).tolist()) == {0.0, np.float32(1 / 0.7)}
    assert abs((mask == 0).float().mean().item() - 0.3) < 0.03
    np.testing.assert_array_equal(
        mask.numpy(), dp.draw(x, torch.Generator().manual_seed(0)).numpy())
    y = dp(x, mask)
    assert (y == mask).all()  # the whole sample is kept or dropped
    assert dp.eval().draw(x) is None and DropPath(0.0).train().draw(x) is None

    net = RepLKNet("t", drop_path_rate=0.3)
    layers = REPLK_CONFIGS["t"]["layers"]
    want = np.linspace(0.0, 0.3, sum(layers))
    got = [[blk.drop_path.rate for blk in stage.blocks] for stage in net.stages]
    flat = [rates[2 * i] for rates in got for i in range(len(rates) // 2)]
    np.testing.assert_allclose(flat, want)
    assert all(r[2 * i] == r[2 * i + 1] for r in got for i in range(len(r) // 2))


def _tiny_step(opt, seed=0, steps=1, batch=B):
    """A port step on seeded random weights at the tiny config; returns
    (model, metrics)."""
    model = RepDepth(opt)
    init_weights(model, torch.Generator().manual_seed(seed))
    state = create_train_state(model, opt, device="cpu",
                               generator=torch.Generator().manual_seed(seed))
    optim, sched = make_optimizer(
        [p for p in model.parameters() if p.requires_grad], LR, 100)
    step = make_train_step(model, opt, optim, sched)
    batch = make_batch(opt, batch)
    for _ in range(steps):
        state, metrics = step(state, batch)
    return model, metrics


def test_use_checkpoint_keeps_gradients_and_statistics():
    """With drop path on, activation checkpointing recomputes each block
    with the masks of its first forward and leaves BN statistics as one
    forward sets them: gradients within f32 rounding (atol 1e-6 of
    gradients ~1e-2), statistics identical."""
    opt = TINY.replace(drop_path_rate=0.3)
    plain, m1 = _tiny_step(opt)
    ckpt, m2 = _tiny_step(opt.replace(use_checkpoint=True))
    assert m1["loss"].item() == m2["loss"].item()
    g1, g2 = _grads(plain), _grads(ckpt)
    for n in g1:
        np.testing.assert_allclose(g2[n], g1[n], rtol=0, atol=1e-6, err_msg=n)
    b2 = dict(ckpt.named_buffers())
    for n, b in plain.named_buffers():
        np.testing.assert_array_equal(b2[n].numpy(), b.numpy(), err_msg=n)


def test_bfloat16_step_keeps_f32_state():
    """compute_dtype bfloat16 (autocast): finite losses near the f32 step's
    (within 2e-2, bf16 rounding through the tiny net), f32 parameters,
    gradients and Adam moments."""
    _, m32 = _tiny_step(OPT)
    model, m16 = _tiny_step(OPT.replace(compute_dtype="bfloat16"))
    for k, v in m16.items():
        assert np.isfinite(v.item()), k
    assert abs(m16["loss"].item() - m32["loss"].item()) < 2e-2
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32, n
        if p.requires_grad:
            assert p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all(), n


def test_step_lr_schedule_and_options():
    """StepLR per epoch as the optax schedule: factor gamma ** (epoch //
    15), one scheduler step per full batch under --grad_accum 2 (stage-2
    freezing is held to JAX in tests/test_torch_stage2.py); a step under
    --grad_accum 2 wants one StepDraws per microbatch."""
    f = step_lr_factor(steps_per_epoch=10)
    assert [f(s) for s in (0, 149, 150, 299, 300)] == [1, 1, 0.1, 0.1, 0.1 ** 2]
    opt = OPT.replace(grad_accum=2)
    model = RepDepth(opt)
    init_weights(model, torch.Generator().manual_seed(0))
    state = create_train_state(model, opt, device="cpu")
    optim, sched = make_optimizer(
        [p for p in model.parameters() if p.requires_grad], LR, 100)
    step = make_train_step(model, opt, optim, sched)
    state, _ = step(state, make_batch(opt, 4))
    assert state.step == 1 and sched.last_epoch == 1
    assert optim.state_dict()["state"][0]["step"].item() == 1
    with pytest.raises(ValueError, match="2 microbatches"):
        step(state, make_batch(opt, 4), draws=draw(state.generator, 2, 64, 96))


def test_use_checkpoint_under_grad_accum_updates_bn_per_microbatch():
    """With activation checkpointing the held statistics of each block's
    recompute leave one BN update per microbatch: under --grad_accum 2 the
    running statistics and batch counters equal those of the step without
    checkpointing, gradients within f32 rounding."""
    opt = OPT.replace(grad_accum=2)
    plain, m1 = _tiny_step(opt, batch=4)
    ckpt, m2 = _tiny_step(opt.replace(use_checkpoint=True), batch=4)
    assert m1["loss"].item() == m2["loss"].item()
    g1, g2 = _grads(plain), _grads(ckpt)
    for n in g1:
        np.testing.assert_allclose(g2[n], g1[n], rtol=0, atol=1e-6, err_msg=n)
    b2 = dict(ckpt.named_buffers())
    for n, b in plain.named_buffers():
        np.testing.assert_array_equal(b2[n].numpy(), b.numpy(), err_msg=n)
        if n.endswith("replk.stages.0.blocks.0.prelkb_bn.num_batches_tracked"):
            assert b.item() == 4  # current and lookup frames, two microbatches
