"""The port's stage-1 training step against JAX `make_train_step` on the
CPU, in f32, at rep_size "t", 64x96, B=2, adapters (adpt_test 4),
drop_path_rate 0 and no matching augmentation, on the same weights (the
whole JAX tree converted by `ckpt.convert.state_dict_from_jax`), the same
batch and the JAX step's own automask noise handed to the port: loss and
metrics, gradients leaf by leaf, Adam's moments, the updated parameters,
BN running statistics, the depth bins and the trainable set. The JAX step
runs once per module.
The semantics the parity run switches off are tested in
tests/test_torch_train_semantics.py.
"""

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from ppeadepth_tpu.models import RepDepth as JRepDepth
from ppeadepth_tpu.train import schedule as jschedule
from ppeadepth_tpu.train.step import create_train_state as jax_create_state
from ppeadepth_tpu.train.step import make_train_step as jax_make_step
from ppeadepth_tpu_torch.ckpt.convert import state_dict_from_jax
from ppeadepth_tpu_torch.models import RepDepth
from ppeadepth_tpu_torch.train.schedule import make_optimizer
from ppeadepth_tpu_torch.train.step import (
    StepDraws, create_train_state, make_train_step)
from tests.test_train_step import make_batch
from tests.torch_parity import TINY, compile_reference, jax_repdepth
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

OPT = TINY.replace(drop_path_rate=0.0, no_matching_augmentation=True)
B = 2
LR = 1e-4
SEED = 7
# 1 - b1 as both optimizers round it: Adam's first moment is exactly
# fl(B1C * g), so the JAX gradient is mu / B1C
B1C = np.float32(1 - 0.9)
# Gradient bounds. f32 sums over thousands of terms (BN backward, conv
# weight gradients) carry an error set by the terms' size, not by the
# result's: a leaf whose gradient cancels to ~1e-5 (the teacher's deep BN
# parameters) shows up to ~30 % relative error while its absolute error
# stays below 4e-4 of the largest gradient entry. So each leaf is held to
# max|d g| <= GRAD_REL * max|g_leaf| + GRAD_ABS * max|g| over all leaves
# (observed worst: 2.7e-4 of max|g|), and the concatenated gradient to a
# relative L2 error of GRAD_L2 (observed 3.6e-5 to 6.3e-5 as the CPU
# thread count changes the summation order).
GRAD_REL = 2e-3
GRAD_ABS = 1e-3
GRAD_L2 = 2e-4


def _flat_sd(tree):
    """A flat {path tuple: array} partition -> {port name: array}."""
    return {k: v.numpy() for k, v in state_dict_from_jax(
        traverse_util.unflatten_dict(tree), {}).items()}


@pytest.fixture(scope="module")
def jax_run():
    return run_jax_step(OPT)


def run_jax_step(opt):
    """One JAX step of `opt` on `jax_repdepth(opt)`: (trainable before,
    after, Adam mu/nu, batch_stats, metrics), all under the port's names,
    and the step's noise; with the compiled step, its start state, batch,
    key and `opt` for further steps."""
    params, stats = jax_repdepth(opt)
    model = JRepDepth(opt)
    tx = jschedule.make_optimizer(LR, steps_per_epoch=100)
    state = jax_create_state(model, {"params": params, "batch_stats": stats},
                             opt, tx)
    batch = make_batch(opt, B)
    rng = jax.random.PRNGKey(SEED)
    step = compile_reference(jax_make_step(model, opt, tx, donate=False),
                             state, batch, rng)
    new, metrics = step(state, batch, rng)
    adam = new.opt_state[0]
    _, _, rng_n1, rng_n2 = jax.random.split(rng, 4)
    noise = [np.asarray(jax.random.normal(r, (B, opt.height, opt.width, 1)))
             for r in (rng_n1, rng_n2)]
    return dict(
        params=params, stats=stats, batch=batch, noise=noise,
        trainable=_flat_sd(state.trainable), new=_flat_sd(new.trainable),
        mu=_flat_sd(adam.mu), nu=_flat_sd(adam.nu),
        stats_new={k: v.numpy() for k, v in state_dict_from_jax(
            {}, new.batch_stats).items()},
        metrics={k: float(v) for k, v in metrics.items()},
        step=step, state=state, rng=rng, opt=opt)


@pytest.fixture(scope="module")
def port_run(jax_run):
    return run_port_step(jax_run)


def run_port_step(jax_run):
    """The port's step on the JAX run's weights, batch and noise: (model,
    its parameters before the step, optimizer, metrics)."""
    model, optim, state, step, draws, batch = _port_step(jax_run)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    _, metrics = step(state, batch, draws)
    return model, before, optim, {k: v.item() for k, v in metrics.items()}


def _port_step(jax_run):
    """(model, optimizer, state, step, draws, batch) of a fresh port model
    on the JAX run's weights, batch and noise."""
    opt = jax_run["opt"]
    model = RepDepth(opt)
    model.load_state_dict(state_dict_from_jax(jax_run["params"], jax_run["stats"]),
                          strict=True)
    state = create_train_state(model, opt, device="cpu")
    optim, sched = make_optimizer(
        [p for p in model.parameters() if p.requires_grad], LR, 100)
    draws = StepDraws(aug_u=torch.zeros(B),
                      noise_mono=torch.tensor(jax_run["noise"][0]),
                      noise_multi=torch.tensor(jax_run["noise"][1]))
    batch = {k: np.asarray(v) for k, v in jax_run["batch"].items()}
    return (model, optim, state, make_train_step(model, opt, optim, sched),
            draws, batch)


def _grads(model):
    return {n: p.grad.numpy() for n, p in model.named_parameters()
            if p.requires_grad}


def test_trainable_set_matches_jax_labels(jax_run, port_run):
    """requires_grad follows the JAX freeze labels mapped to the port's
    names: the same names, the same count, the same sizes."""
    model = port_run[0]
    names = {n for n, p in model.named_parameters() if p.requires_grad}
    assert names == set(jax_run["trainable"])
    assert len(names) == len(jax_run["trainable"]) > 0
    sizes = {n: p.numel() for n, p in model.named_parameters()}
    assert (sum(sizes[n] for n in names)
            == sum(a.size for a in jax_run["trainable"].values()))
    assert all(p.requires_grad == (n in names) for n, p in model.named_parameters())


def test_step_loss_and_metrics_match_jax(jax_run, port_run):
    """The same keys; values within 1e-5 (f32 rounding, observed 5e-7; one
    flipped automask pixel would move a reprojection mean by ~5e-5)."""
    got, ref = port_run[3], jax_run["metrics"]
    assert set(got) == set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-5, (k, got[k], ref[k])


def _assert_leaf_close(got, ref, scale, name):
    err = np.abs(got - ref).max()
    assert err <= GRAD_REL * np.abs(ref).max() + GRAD_ABS * scale, (
        name, err, np.abs(ref).max(), scale)


def test_step_gradients_match_jax(jax_run, port_run):
    """Every trainable leaf within its bound (GRAD_REL, GRAD_ABS above) and
    the concatenated gradient within GRAD_L2 relative L2."""
    grads = _grads(port_run[0])
    refs = {n: jax_run["mu"][n] / B1C for n in grads}
    scale = max(np.abs(r).max() for r in refs.values())
    for n, g in grads.items():
        assert np.abs(refs[n]).max() > 0, n
        _assert_leaf_close(g, refs[n], scale, n)
    dall = np.concatenate([(grads[n] - refs[n]).ravel() for n in grads])
    gall = np.concatenate([refs[n].ravel() for n in grads])
    assert np.linalg.norm(dall) <= GRAD_L2 * np.linalg.norm(gall)


def test_step_adam_moments_match_jax(jax_run, port_run):
    """exp_avg against optax's mu and exp_avg_sq against nu, each brought
    to the gradient's scale (mu / 0.1 = g, sqrt(nu / 0.001) = |g|) and held
    to the gradient's bounds."""
    model, _, optim, _ = port_run
    b2c = np.float32(1 - 0.999)
    scale = max(np.abs(jax_run["mu"][n]).max() / B1C for n in jax_run["mu"])
    for n, p in model.named_parameters():
        if not p.requires_grad:
            assert p not in optim.state
            continue
        st = optim.state[p]
        _assert_leaf_close(st["exp_avg"].numpy() / B1C, jax_run["mu"][n] / B1C,
                           scale, n)
        _assert_leaf_close(np.sqrt(st["exp_avg_sq"].numpy() / b2c),
                           np.sqrt(jax_run["nu"][n] / b2c), scale, n)


def test_step_updated_parameters_match_jax(jax_run, port_run):
    """Adam's first step moves each entry by about lr * sign(g): compared
    where |g| exceeds 100 times its leaf's gradient error (a sign that can
    not flip), atol 2.5e-7: two f32 ulps of |p| < 2, as torch and optax
    round the bias-corrected update in another order. Frozen parameters
    are bit-unchanged."""
    model, before, _, _ = port_run
    grads = _grads(model)
    compared = 0
    for n, p in model.named_parameters():
        got = p.detach().numpy()
        if not p.requires_grad:
            np.testing.assert_array_equal(got, before[n].numpy(), err_msg=n)
            continue
        ref_g = jax_run["mu"][n] / B1C
        sure = np.abs(ref_g) > 100 * np.abs(grads[n] - ref_g).max()
        np.testing.assert_allclose(got[sure], jax_run["new"][n][sure], rtol=0,
                                   atol=2.5e-7, err_msg=n)
        moved = np.abs(jax_run["new"][n] - jax_run["trainable"][n])
        assert (moved[sure] > 0.5 * LR).all(), n
        compared += sure.sum()
    assert compared > 0.75 * sum(g.size for g in grads.values())


def test_step_batch_stats_match_jax(jax_run, port_run):
    """Every BN's running mean and (unbiased) variance after one train-mode
    step, atol 1e-4 (observed 1.7e-5: momentum 0.1 of batch statistics
    rounded in another order)."""
    buffers = dict(port_run[0].named_buffers())
    ref = jax_run["stats_new"]
    init = state_dict_from_jax({}, jax_run["stats"])
    assert ref and set(ref) <= set(buffers)
    for k, v in ref.items():
        assert not np.array_equal(v, init[k].numpy()), k  # the step moved it
        np.testing.assert_allclose(buffers[k].numpy(), v, rtol=0, atol=1e-4,
                                   err_msg=k)


def test_step_depth_bins_match_jax(jax_run, port_run):
    """The EMA of the teacher depth's widened min/max (step.py:434-440),
    rtol 1e-6."""
    got, ref = port_run[3], jax_run["metrics"]
    for k in ("depth_bins/min", "depth_bins/max"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6)
    assert ref["depth_bins/max"] != 10.0  # the EMA moved


def test_steps_track_jax(jax_run):
    """Four steps of each on the same batch and draws: Adam past its
    sign-only first step, the schedule, and the state's BN statistics and
    depth bins carried from step to step. The bins follow JAX within 1e-5
    relative (the EMA of the teacher's depth extremes; observed 3e-7); the
    loss within 1e-5 at the first step and 5e-3 relative after, as entries
    with a near-zero gradient take lr steps of either sign in the two
    packages and the runs drift apart (observed 2.3e-4)."""
    _, _, state, step, draws, batch = _port_step(jax_run)
    jstate = jax_run["state"]
    for i in range(4):
        jstate, jmet = jax_run["step"](jstate, jax_run["batch"], jax_run["rng"])
        state, met = step(state, batch, draws)
        got, ref = met["loss"].item(), float(jmet["loss"])
        assert abs(got - ref) <= (1e-5 if i == 0 else 5e-3 * abs(ref)), (i, got, ref)
        for k in ("depth_bins/min", "depth_bins/max"):
            np.testing.assert_allclose(met[k].item(), float(jmet[k]), rtol=1e-5,
                                       err_msg=f"{k} step {i}")
    assert state.step == 4
