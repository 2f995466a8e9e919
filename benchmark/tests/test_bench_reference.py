"""The benchmark's plain reference against the measured program's CPU
path at a tiny size ("t" widths, 64x96, B=2), in float32: one serving
forward of each mode and one step of each training stage.

The reference is an independent implementation: `F.conv2d` for every
depthwise conv, `F.grid_sample` for the loss warp, its own gather for the
cost volume, no BN folding or kernel merging. So the two agree to f32
round-off, not bit for bit:
  * serving: the program folds BN and merges the small kernel into the
    large one, which moves the disparity by ~1e-7; 1e-5 leaves room for
    the cost volume's sums taken in another order;
  * training: the same weights, inputs, draws and drop-path masks give
    losses within 5e-5 (relative; f32 sums over 12k pixels and the loss
    warp's bilinear weights in another order); the gradient of each
    leaf, as a gap over the larger of its norm and the median leaf's
    (some leaves' gradients are all but zero), within 1e-3 for the
    median leaf and 3e-2 for the worst: a leaf whose gradient is a sum
    over pixels that cancels (the decoders' and stems' biases and BN
    scales) carries the round-off of another order of operations
    amplified (on the card the f32 program against this reference read
    medians of 4e-4 to 2.8e-3 and worst leaves of 0.04 to 0.055 at full
    size); BN statistics within 1e-4 and depth bins within 1e-5.
"""

import numpy as np
import pytest
import torch

import run
from bench_tiny import tiny_cell
from harness import check, program, weights
from reference import nets
from reference import train as ref_train

SEED = 20260


@pytest.fixture(scope="module")
def port():
    return program.port()


@pytest.mark.parametrize("workload", ["kitti-serve-student-b32",
                                      "cs-dc-serve-teacher-b32"])
def test_serving_forward(port, workload):
    cell = tiny_cell(workload, serve_dtype="float32")
    sd = weights.state_dict(cell["config"], SEED, "cpu")
    loop = run.make_loop(port, cell, sd, SEED, "cpu")
    o = cell["config"]["options"]
    for e in range(len(loop.pool)):
        depth = loop.fn(*loop.pool[e])
        got = check.depth_to_disp(depth, o["min_depth"], o["max_depth"])
        ref = check.reference_disp(cell["config"], sd, loop.pool[e], loop.mode, "cpu")
        assert np.abs(got - ref).max() < 1e-5


def _port_step(port, cell, sd):
    loop = run.make_loop(port, cell, sd, SEED, "cpu")
    loop.unit()
    return loop


@pytest.mark.parametrize("workload", ["kitti-train-b12", "cs-dc-train-b12"])
def test_training_step(port, workload):
    cell = tiny_cell(workload, compute_dtype="float32")
    sd = weights.state_dict(cell["config"], SEED, "cpu")
    loop = run.make_loop(port, cell, sd, SEED, "cpu")
    metrics = loop.unit()

    model = nets.RepDepth(cell["config"])
    model.load_state_dict(sd, strict=True)
    tr = ref_train.Trainer(model, loop.opt.learning_rate, loop.drop_seed)
    loss, _, _ = tr.step(loop.pool[0], loop.draws[0])

    assert abs(float(metrics["loss"]) - float(loss)) <= 5e-5 * abs(float(loss))
    prog = dict(loop.model.named_parameters())
    assert set(tr.params) == {n for n, p in prog.items() if p.requires_grad}
    med = np.median([float(p.grad.norm()) for p in tr.params.values()])
    gaps = {name: float((prog[name].grad - p.grad).norm())
            / max(float(p.grad.norm()), med) for name, p in tr.params.items()}
    assert max(gaps.values()) <= 3e-2, max(gaps.items(), key=lambda kv: kv[1])
    assert np.median(list(gaps.values())) <= 1e-3
    bufs = dict(loop.model.named_buffers())
    for name, b in check.bn_buffers(model.named_buffers()).items():
        assert torch.allclose(bufs[name], b, rtol=1e-4, atol=1e-5), name
    assert abs(float(loop.state.min_depth_bin) - float(tr.min_bin)) < 1e-5
    assert abs(float(loop.state.max_depth_bin) - float(tr.max_bin)) < 1e-4
