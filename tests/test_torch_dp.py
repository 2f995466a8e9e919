"""The port's data parallelism (`ppeadepth_tpu_torch.parallel.dist`) on the
CPU: two ranks under gloo, spawned as OS processes as
tests/test_distributed_dp.py does for JAX, against the port's one-process
run of the same work (`tests/torch_dist_worker.py`, in this process, no
process group) and against JAX's one-process step:

  * `GlobalBatchNorm` over 2 ranks == `nn.BatchNorm2d` over the whole
    batch: output, input and parameter gradients, running statistics;
  * one stage-1 step at rep_size "t", 64x96: the JAX parity setup (global
    batch 2, the JAX step's noise handed in), drop path and matching
    augmentation drawn (global batch 2), and --grad_accum 2 (global batch
    4): metrics and depth bins, gradients, updated parameters and BN
    statistics equal the one-process step's to f32 reduction order, and
    the first one JAX's step within test_distributed_dp.py's 3e-4
    relative on the loss and the bins, and test_torch_train_step.py's
    bounds on the parameters and BN statistics;
  * the Trainer on a synthetic KITTI set (2 steps of global batch 2, a
    validation split over the ranks): the same losses, validation errors
    and final weights as one process, and only rank 0 writes checkpoints
    and metrics.jsonl.

The JAX step is this file's one compile."""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from ppeadepth_tpu_torch.ckpt.convert import state_dict_from_jax
from ppeadepth_tpu_torch.data.loader import DataLoader, rank_share
from tests import test_torch_train_step as S1
from tests import torch_dist_worker as worker
from tests.test_train_step import make_batch
from tests.torch_parity import kitti_set
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
# one rank against one process: the same f32 arithmetic summed in another
# order (the BN statistics, the loss sums, the gradient all-reduce).
# Observed: metrics 3.4e-7 to 1.4e-6 relative; BN statistics 2.7e-5 to
# 4.5e-5, at the stage-3 BNs, which normalise over 12 values a channel
# (stage 1's BN bound, 1e-4).
METRIC_RTOL = 1e-5
BUFFER_ATOL = 1e-4


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(indir, outdir):
    """The two ranks as OS processes; their result dicts by rank."""
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_dist_worker.py"),
         port, str(WORLD), str(r), indir, outdir],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=900)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out[-4000:]}"
    runs = []
    for r in range(WORLD):
        with open(os.path.join(outdir, f"rank{r}.pkl"), "rb") as f:
            runs.append(pickle.load(f))
    return runs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX run, one-process run, [rank 0 run, rank 1 run])."""
    root = tmp_path_factory.mktemp("dp")
    jax_run = S1.run_jax_step(S1.OPT)
    opt = jax_run["opt"]
    torch.save(state_dict_from_jax(jax_run["params"], jax_run["stats"]),
               str(root / "state.pt"))
    noise = jax_run["noise"]
    inputs = {
        "A": ({k: np.asarray(v) for k, v in jax_run["batch"].items()},
              dict(aug_u=np.zeros(S1.B, np.float32), noise_mono=noise[0],
                   noise_multi=noise[1])),
        "B": ({k: np.asarray(v) for k, v in make_batch(opt, 2, seed=1).items()},
              None),
        "accum": ({k: np.asarray(v) for k, v in
                   make_batch(opt, 4, seed=2).items()}, None),
    }
    with open(root / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    kitti_set(root / "data", 4, 3)
    one = worker.run_all(str(root), str(root / "one"))
    two = _spawn(str(root), str(root / "two"))
    return jax_run, one, two


def test_global_bn_matches_batchnorm2d(runs):
    """Two ranks' GlobalBatchNorm == nn.BatchNorm2d over the whole batch,
    and one process's GlobalBatchNorm is nn.BatchNorm2d."""
    _, one, two = runs
    x, w, weight, bias = worker.bn_inputs()
    bn = torch.nn.BatchNorm2d(6)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    x = x.clone().requires_grad_()
    y = bn(x)
    (y * w).sum().backward()
    ref = dict(y=y.detach().numpy(), dx=x.grad.numpy(),
               dweight=bn.weight.grad.numpy(), dbias=bn.bias.grad.numpy(),
               running_mean=bn.running_mean.numpy(),
               running_var=bn.running_var.numpy())
    ranks = [r["global_bn"] for r in two]
    for k in ("y", "dx"):
        got = np.concatenate([r[k] for r in ranks])
        np.testing.assert_allclose(got, ref[k], rtol=1e-5, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(one["global_bn"][k], ref[k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    for k in ("dweight", "dbias"):  # each rank its share; the sum is the whole
        np.testing.assert_allclose(ranks[0][k] + ranks[1][k], ref[k],
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    for k in ("running_mean", "running_var"):
        for r in ranks:
            np.testing.assert_allclose(r[k], ref[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)
    assert all(r["count"] == 1 for r in ranks)


def _assert_step_close(got, ref, metric_rtol, buffer_atol):
    """Metrics within metric_rtol; the updated parameters (Adam's first,
    sign-like step) at atol 2.5e-7 where |g| exceeds 100 times the leaf's
    gradient difference (stage 1's rule, test_torch_train_step.py); BN
    statistics within buffer_atol."""
    assert set(got["metrics"]) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=metric_rtol,
                                   err_msg=k)
    assert set(got["params"]) == set(ref["params"])
    for n, p in ref["params"].items():
        g_ref, g = ref["grads"][n], got["grads"][n]
        sure = np.abs(g_ref) > 100 * np.abs(g - g_ref).max()
        np.testing.assert_allclose(got["params"][n][sure], p[sure], rtol=0,
                                   atol=2.5e-7, err_msg=n)
    for n, b in ref["buffers"].items():
        np.testing.assert_allclose(got["buffers"][n], b, rtol=0,
                                   atol=buffer_atol, err_msg=n)


@pytest.mark.parametrize("name", list(worker.OPTS))
def test_dp_step_matches_one_process(runs, name):
    """Both ranks hold the same replicated result, and it is the one
    process's step on the whole global batch with the same draws."""
    _, one, two = runs
    key = "step_" + name
    for r in two:
        _assert_step_close(r[key], one[key], METRIC_RTOL, BUFFER_ATOL)
    g = one[key]["grads"]
    for n in g:  # the gradient is the whole batch's, not a rank's
        np.testing.assert_allclose(two[0][key]["grads"][n],
                                   two[1][key]["grads"][n], rtol=0, atol=0)
    assert one[key]["metrics"]["depth_bins/max"] != 10.0


def test_dp_step_matches_jax(runs):
    """Rank 0's step A against JAX's one-process step: the loss and the
    depth bins within 3e-4 relative (test_distributed_dp.py's bound), the
    updated parameters as test_torch_train_step.py (gradients from Adam's
    first moment), the BN statistics within its 1e-4."""
    jax_run, _, two = runs
    got = two[0]["step_A"]
    for k in ("loss", "depth_bins/min", "depth_bins/max"):
        np.testing.assert_allclose(got["metrics"][k], jax_run["metrics"][k],
                                   rtol=3e-4, err_msg=k)
    ref = dict(metrics=got["metrics"], params=jax_run["new"],
               grads={n: jax_run["mu"][n] / S1.B1C for n in jax_run["new"]},
               buffers=jax_run["stats_new"])
    _assert_step_close(got, ref, 0.0, 1e-4)


def test_dp_trainer_matches_one_process(runs):
    """The Trainer over 2 ranks from the step runs' weights: each step's
    loss as one process's within 1e-4 relative (observed 1.3e-5: on the
    loader's batch a near-tied pixel of the teacher's automask flips,
    mono/reproj moving 2.8e-5 while multi/reproj agrees exactly; one flip
    moves a reprojection mean by ~5e-5, test_torch_train_step.py), the
    validation errors (the third test image on rank 0 alone) within 1e-5
    relative, the final weights within 4e-4 (two Adam steps of lr 1e-4
    move an entry by about lr each, and a near-zero gradient's entry may
    move either way in the two runs; observed 1.5e-4) and BN statistics,
    which the second step takes from those weights, within BUFFER_ATOL
    plus 1e-3 relative (observed 1.1e-4 at 1.2); rank 0 alone wrote the checkpoints and
    metrics.jsonl."""
    _, one, two = runs
    ref = one["trainer"]
    assert len(ref["losses"]) == 2 and len(ref["errors"]) == 1
    for r in two:
        got = r["trainer"]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
        np.testing.assert_allclose(got["errors"], ref["errors"], rtol=1e-5)
        for k, v in ref["final"].items():
            if k.endswith("num_batches_tracked"):
                assert (got["final"][k] == v).all(), k
            else:
                tol = (dict(rtol=1e-3, atol=BUFFER_ATOL) if ".running_" in k
                       else dict(rtol=0, atol=4e-4))
                np.testing.assert_allclose(got["final"][k], v, err_msg=k, **tol)
    assert ref["saved"] == ["dp_s2", "dp_final"] and ref["metrics_file"]
    assert two[0]["trainer"]["saved"] == ref["saved"]
    assert two[0]["trainer"]["metrics_file"]
    assert two[1]["trainer"]["saved"] == [None, None]
    assert not two[1]["trainer"]["metrics_file"]


def test_rank_shares_cover_the_global_batch():
    """Every rank's share of each shuffled global batch: disjoint, in
    order, together the one-process batch; a short batch leaves the last
    rank less."""
    class Items:
        def __len__(self):
            return 10

        def __getitem__(self, i, epoch=0):
            return {"i": np.array(i)}

    ref = [b["i"].tolist() for b in DataLoader(Items(), 4, num_workers=1)]
    shares = [[b["i"].tolist() for b in DataLoader(
        Items(), 4, num_workers=1, rank=r, world=WORLD)] for r in range(WORLD)]
    assert [a + b for a, b in zip(*shares)] == ref
    assert rank_share(list(range(3)), 1, 2) == [2]
    assert rank_share(list(range(1)), 1, 2) == []
