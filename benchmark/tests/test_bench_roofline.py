"""The operation and byte counts of `roofline/`, recomputed at the shapes
PERF.md recorded its bounds at (NVIDIA H100 SXM data-sheet peaks); the
launches that `harness/model_pass.py` works out from the reference's
calls at a cell's shapes, against the program's launch counts; and
FlopCounterMode's count of a depthwise conv against the hand formula."""

import copy

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from bench_tiny import bench_with_held
from harness import cells, model_pass, peaks


def _mod(name):
    return cells.load_module("roofline", name)


def _launches(kernel, workload, mode=None, batch=None, height=None, width=None):
    """The kernel's launches in one unit of the cell (its configuration at
    the given sizes; the pass as the cell's loop makes it)."""
    cell = copy.deepcopy(cells.cell(workload, bench_with_held()))
    o = cell["config"]["options"]
    o.update({k: v for k, v in (("height", height), ("width", width)) if v})
    mix = cell["traffic"]
    train = mix["kind"] == "train_steps"
    p = {"pass": "train" if train else (mode or mix["mode"]),
         "batch": batch or mix["batch"], "form": "train" if train else "merged",
         "dtype": "bf16"}
    calls = model_pass.count(cell["config"], [p])[1][0]
    return _mod(kernel).launches(calls, p)


def _bound_ms(mod, calls, peak=None):
    total = 0.0
    for dtype, args in calls:
        flop, nbytes = mod.work(*args)
        rate = peak or peaks.FLOP_PER_S[dtype]
        total += max(nbytes / peaks.HBM_BYTES_PER_S, flop / rate)
    return 1e3 * total


def test_kernel_b_teacher_forward():
    """PERF.md (PR 7 on): kernel B's bound per B=8 teacher forward at
    640x192, 0.4153 ms at 989 TFLOP/s, from operations."""
    mod = _mod("ffn_fused")
    calls = _launches("ffn_fused", "cs-dc-serve-teacher-b32", batch=8, width=640)
    assert len(calls) == 24
    assert _bound_ms(mod, calls) == pytest.approx(0.4153, abs=5e-5)
    flop, nbytes = mod.work(*calls[0][1])
    assert flop / 989e12 > nbytes / 3.35e12  # operations bound it


def test_kernel_d_forward_bytes():
    """PERF.md (PR 9): kernel D's forward at one branch's warp, 24 images
    of 640x192: 94.4 MB, bound 0.0282 ms from bytes."""
    mod = _mod("warp_border")
    flop, nbytes = mod.work(24, 192, 640, "forward")
    assert nbytes == 4 * 24 * 192 * 640 * 8 == 94_371_840
    assert 1e3 * nbytes / 3.35e12 == pytest.approx(0.0282, abs=5e-5)
    calls = _launches("warp_border", "kitti-train-b12")
    assert sorted(c[1] for c in calls) == sorted(
        [(24, 192, 640, "forward")] * 2 + [(24, 192, 640, "backward")] * 2)
    assert _launches("warp_border", "kitti-serve-student-b32") == []


def test_kernel_c_bound():
    """Kernel C at [8, 48, 160, 128] bf16 and 96 bins: the features read
    once and the f32 differences written once, 55,050,240 bytes. PERF.md's
    0.1212 ms (PR 9, operations at the 67 TFLOP/s CUDA-core rate) counted
    only the samples its poses left inside the frame, so it lies below
    the same count over every sample."""
    mod = _mod("plane_sweep")
    flop, nbytes = mod.work(8, 128, 48, 160, 96, 2)
    assert nbytes == 2 * 8 * 48 * 160 * 128 * 2 + 4 * 8 * 96 * 48 * 160 == 55_050_240
    assert flop == 12 * 128 * 8 * 96 * 48 * 160 + 12 * 8 * 96 * 48 * 160
    assert 0.1212 < 1e3 * flop / 67e12 < 0.1212 / 0.85
    assert _launches("plane_sweep", "kitti-serve-student-b32", batch=8) == [
        ("f32", (8, 128, 48, 160, 96, 2))]
    assert len(_launches("plane_sweep", "kitti-train-b12")) == 1
    assert _launches("plane_sweep", "cs-dc-serve-teacher-b32") == []


def test_kernel_a_launches():
    """Kernel A's launches a unit equal the program's launch counts
    (PERF.md: a teacher request 24, a student request 26, a stage-1 or
    stage-2 step 100 + 96), and kernel B's calls 24 and 26 and none in
    training."""
    mod = _mod("lk_dwconv")
    assert len(_launches("lk_dwconv", "cs-dc-serve-teacher-b32")) == 24
    assert len(_launches("lk_dwconv", "kitti-serve-student-b32")) == 26
    assert len(_launches("lk_dwconv", "kitti-train-b12")) == 196
    assert len(_launches("lk_dwconv", "cs-dc-train-b12")) == 196
    assert len(_launches("ffn_fused", "kitti-serve-student-b32")) == 26
    assert _launches("ffn_fused", "kitti-train-b12") == []
    # a 3x3 SAME conv on 4x4: taps per axis 2 + 3 + 3 + 2
    flop, nbytes = mod.work(1, 1, 4, 4, 3, 2)
    assert flop == 2 * 10 * 10 and nbytes == 2 * (2 * 16 + 9)


@pytest.mark.parametrize("k", [3, 13, 31])
def test_flop_counter_depthwise(k):
    """FlopCounterMode counts a depthwise conv as 2 B C H W k^2 (every tap,
    padding included): the model FLOPs of `mfu.*` are that count."""
    B, C, H, W = 2, 8, 12, 20
    x = torch.randn(B, C, H, W)
    w = torch.randn(C, 1, k, k)
    with FlopCounterMode(display=False) as fc:
        F.conv2d(x, w, padding=k // 2, groups=C)
    assert fc.get_total_flops() == 2 * B * C * H * W * k * k


def test_peaks_never_under_the_published_rates():
    assert peaks.FLOP_PER_S == {"bf16": 989e12, "f32": 495e12}
    assert peaks.HBM_BYTES_PER_S == 3.35e12
