"""The port's training step under `--grad_accum 2` against JAX
`make_train_step` with `grad_accum=2` (its scan over stacked
microbatches) on the CPU, in f32, at rep_size "t", 64x96, B=4, under the
setup and bounds of tests/test_torch_train_step.py (whose checks run on
this step's results): the trainable set, the loss and metrics averaged
over the microbatches, gradients leaf by leaf (summed, then halved), Adam's
moments, the updated parameters, BN running statistics after two
train-mode forwards, and the depth bins. Each microbatch gets the noise
of its own key, `jax.random.split(key, 2)[i]`. Also the strided split
itself. The JAX step is this file's one compile.

Both microbatches hold S1's own batch (`make_batch(OPT, 2)`, seed 0),
on which S1's bounds were set, each with its own noise. make_batch's
frames -1 and +1 are mirror shifts of frame 0, so the teacher's min over
their reprojection losses and the matching mask hold near-ties, and where
f32 rounding breaks one differently in the two packages a gradient moves
past S1's bounds (the flips they leave out). Measured against JAX's step
at grad_accum 1 on the halves of `make_batch(OPT, 4, seed=s)`, s = 0-5,
and on S1's batch darkened to 0.9: every one but seed 4 has a half whose
pose-encoder leaves exceed the per-leaf bound (up to 8.6x), seed 4's
second half exceeds the relative L2 bound (4.8e-4 against 2e-4), the
darkened batch gives 2.7e-3; the metrics agree within 1e-6 save seed 0's
first half (a matching-mask pixel 1.5e-6 from its threshold). So the
accumulation over distinct microbatches is held port against port
(`test_accum_is_the_mean_of_microbatch_steps`): the step at grad_accum 2
against two steps at grad_accum 1 on its halves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppeadepth_tpu.models import RepDepth as JRepDepth
from ppeadepth_tpu.train import schedule as jschedule
from ppeadepth_tpu.train.step import create_train_state as jax_create_state
from ppeadepth_tpu.train.step import make_train_step as jax_make_step
from ppeadepth_tpu.train.step import stack_microbatches
from ppeadepth_tpu_torch.ckpt.convert import state_dict_from_jax
from ppeadepth_tpu_torch.models import RepDepth
from ppeadepth_tpu_torch.train.schedule import make_optimizer
from ppeadepth_tpu_torch.train.step import (
    StepDraws, create_train_state, make_train_step, split_microbatches)
from tests import test_torch_train_step as S1
from tests.test_train_step import make_batch
from tests.torch_parity import compile_reference, jax_repdepth
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

N = 2
B = 4
OPT = S1.OPT.replace(grad_accum=N)


@pytest.fixture(scope="module")
def jax_run():
    """One JAX step of OPT on S1's weights (`jax_repdepth(S1.OPT)`), in the
    layout of `S1.run_jax_step`, with each microbatch's automask noise."""
    params, stats = jax_repdepth(S1.OPT)
    model = JRepDepth(OPT)
    tx = jschedule.make_optimizer(S1.LR, steps_per_epoch=100)
    state = jax_create_state(model, {"params": params, "batch_stats": stats},
                             OPT, tx)
    half = make_batch(OPT, B // N)
    batch = {k: jnp.repeat(v, N, 0) for k, v in half.items()}
    stacked = stack_microbatches(batch, N)
    rng = jax.random.PRNGKey(S1.SEED)
    step = compile_reference(jax_make_step(model, OPT, tx, donate=False),
                             state, stacked, rng)
    new, metrics = step(state, stacked, rng)
    adam = new.opt_state[0]
    noise = []
    for r in jax.random.split(rng, N):
        _, _, n1, n2 = jax.random.split(r, 4)
        noise.append([np.asarray(jax.random.normal(k, (B // N, OPT.height,
                                                       OPT.width, 1)))
                      for k in (n1, n2)])
    return dict(
        params=params, stats=stats, batch=batch, noise=noise,
        trainable=S1._flat_sd(state.trainable), new=S1._flat_sd(new.trainable),
        mu=S1._flat_sd(adam.mu), nu=S1._flat_sd(adam.nu),
        stats_new={k: v.numpy() for k, v in state_dict_from_jax(
            {}, new.batch_stats).items()},
        metrics={k: float(v) for k, v in metrics.items()}, opt=OPT)


@pytest.fixture(scope="module")
def port_both(jax_run):
    """The port's step on the JAX run's weights, batch (B=4, unstacked)
    and per-microbatch noise: (model, parameters before, optimizer,
    metrics), as `S1.run_port_step`; and each BN's batch-counter advance."""
    model = RepDepth(OPT)
    model.load_state_dict(state_dict_from_jax(jax_run["params"],
                                              jax_run["stats"]), strict=True)
    state = create_train_state(model, OPT, device="cpu")
    optim, sched = make_optimizer(
        [p for p in model.parameters() if p.requires_grad], S1.LR, 100)
    draws = [StepDraws(aug_u=torch.zeros(B // N),
                       noise_mono=torch.tensor(n1), noise_multi=torch.tensor(n2))
             for n1, n2 in jax_run["noise"]]
    batch = {k: np.asarray(v) for k, v in jax_run["batch"].items()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    state, metrics = make_train_step(model, OPT, optim, sched)(state, batch,
                                                               draws)
    assert state.step == 1
    counters = {n: b.item() - buffers[n].item()
                for n, b in model.named_buffers()
                if n.endswith("num_batches_tracked")}
    return (model, before, optim, {k: v.item() for k, v in metrics.items()}
            ), counters


@pytest.fixture(scope="module")
def port_run(port_both):
    return port_both[0]


def test_accum_trainable_set_matches_jax_labels(jax_run, port_run):
    S1.test_trainable_set_matches_jax_labels(jax_run, port_run)


def test_accum_loss_and_metrics_match_jax(jax_run, port_run):
    """The microbatches' mean of every metric, within S1's 1e-5."""
    S1.test_step_loss_and_metrics_match_jax(jax_run, port_run)


def test_accum_gradients_match_jax(jax_run, port_run):
    S1.test_step_gradients_match_jax(jax_run, port_run)


def test_accum_adam_moments_match_jax(jax_run, port_run):
    S1.test_step_adam_moments_match_jax(jax_run, port_run)


def test_accum_updated_parameters_match_jax(jax_run, port_run):
    S1.test_step_updated_parameters_match_jax(jax_run, port_run)


def test_accum_batch_stats_match_jax(jax_run, port_run, port_both):
    """Two momentum-0.1 updates in microbatch order, as the JAX scan: every
    BN's batch counter advanced by N times its forwards a microbatch."""
    S1.test_step_batch_stats_match_jax(jax_run, port_run)
    counters = port_both[1]
    assert counters and all(c % N == 0 for c in counters.values())
    assert sum(c > 0 for c in counters.values()) >= len(jax_run["stats_new"]) // 2


def test_accum_depth_bins_match_jax(jax_run, port_run):
    """The EMA of the microbatches' mean teacher-depth extremes."""
    S1.test_step_depth_bins_match_jax(jax_run, port_run)


def test_split_is_strided_as_jax():
    """Microbatch i takes samples i::N, as `stack_microbatches`, for every
    key of the batch."""
    batch = {("color", 0, 0): np.arange(6 * 2 * 3 * 1, dtype=np.float32
                                        ).reshape(6, 2, 3, 1),
             ("K", 2): np.arange(6 * 16, dtype=np.float32).reshape(6, 4, 4)}
    for n in (2, 3):
        ref = stack_microbatches({k: jnp.asarray(v) for k, v in batch.items()}, n)
        got = split_microbatches({k: torch.from_numpy(v)
                                  for k, v in batch.items()}, n)
        assert len(got) == n
        for i, mb in enumerate(got):
            for k, v in mb.items():
                assert v.is_contiguous()
                np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k][i]))
                np.testing.assert_array_equal(v.numpy(), batch[k][i::n])


def test_accum_is_the_mean_of_microbatch_steps(monkeypatch):
    """On distinct microbatches (the strided halves of `make_batch(OPT, 4)`),
    the grad_accum-2 step against two grad_accum-1 steps at learning rate 0
    on a second copy of the same weights, one microbatch each in order
    and each from the same depth bins:
    gradients (g0 + g1) / 2, BN running statistics after both, the
    metrics' mean, and the bin EMA of the microbatches' mean depth
    extremes, within f32 rounding."""
    from ppeadepth_tpu_torch.train import step as step_mod

    params, stats = jax_repdepth(S1.OPT)
    sd = state_dict_from_jax(params, stats)
    batch = {k: np.asarray(v) for k, v in make_batch(OPT, B).items()}
    rng = np.random.RandomState(3)
    draws = [StepDraws(aug_u=torch.zeros(B // N),
                       noise_mono=torch.tensor(rng.randn(B // N, 64, 96, 1)).float(),
                       noise_multi=torch.tensor(rng.randn(B // N, 64, 96, 1)).float())
             for _ in range(N)]
    depths = []
    make_loss = step_mod.make_loss_fn

    def recording(model, opt):
        loss_fn = make_loss(model, opt)

        def fn(*a):
            out = loss_fn(*a)
            depths.append(out[2].detach())
            return out
        return fn

    monkeypatch.setattr(step_mod, "make_loss_fn", recording)

    def setup(opt, lr):
        model = RepDepth(opt)
        model.load_state_dict(sd, strict=True)
        state = create_train_state(model, opt, device="cpu")
        optim, sched = make_optimizer(
            [p for p in model.parameters() if p.requires_grad], lr, 100)
        return model, state, make_train_step(model, opt, optim, sched)

    model, state, step = setup(OPT, S1.LR)
    _, metrics = step(state, batch, draws)
    got_depths, depths[:] = list(depths), []
    ref_model, ref_state, ref_step = setup(S1.OPT, 0.0)
    grads, ref_metrics = [], []
    for mb, dr in zip(split_microbatches(
            {k: torch.from_numpy(v) for k, v in batch.items()}, N), draws):
        # both microbatches see the bins the accumulated step starts from
        _, m = ref_step(ref_state, mb, dr)
        ref_metrics.append(m)
        grads.append({n: p.grad.clone() for n, p in ref_model.named_parameters()
                      if p.requires_grad})
    assert len(got_depths) == len(depths) == N
    for a, b in zip(got_depths, depths):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for n, p in model.named_parameters():
        if p.requires_grad:
            want = (grads[0][n] + grads[1][n]) / N
            err = (p.grad - want).abs().max().item()
            assert err <= 1e-6 * want.abs().max().item(), (n, err, want.abs().max().item())
    ref_buffers = dict(ref_model.named_buffers())
    for n, b in model.named_buffers():
        torch.testing.assert_close(b, ref_buffers[n], rtol=0, atol=0, msg=n)
    for k in ref_metrics[0]:
        if not k.startswith("depth_bins"):
            want = (ref_metrics[0][k] + ref_metrics[1][k]) / N
            torch.testing.assert_close(metrics[k], want, rtol=1e-6, atol=0, msg=k)
    dmin = torch.stack([d.amin(dim=(1, 2, 3)).mean() for d in depths]).mean()
    dmax = torch.stack([d.amax(dim=(1, 2, 3)).mean() for d in depths]).mean()
    want_min = 0.1 * 0.99 + max(OPT.min_depth, dmin.item() * 0.9) * 0.01
    want_max = 10.0 * 0.99 + dmax.item() * 1.1 * 0.01
    np.testing.assert_allclose(metrics["depth_bins/min"].item(), want_min, rtol=1e-6)
    np.testing.assert_allclose(metrics["depth_bins/max"].item(), want_max, rtol=1e-6)
