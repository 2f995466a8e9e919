"""The traced run's reduction on a hand-made trace: device busy time as
the union of device intervals, kernel events by name and category, and
idle gaps labelled by the harness span and the innermost host operator
open when each began."""

import pytest

from harness import cells, model_pass, peaks, trace
from harness.layers import Context


def _summary():
    device = [("void lk_dwconv_kernel<bf16, 31>", 0, 100),
              ("void lk_dwconv_kernel<bf16, 5>", 50, 150),       # overlaps
              ("Memcpy HtoD (Pageable -> Device)", 300, 400),
              ("batch_norm_collect_statistics", 500, 600)]
    host = [("bench:predict_depth", 0, 700), ("aten::conv2d", 140, 320),
            ("aten::cudnn_convolution", 145, 310), ("aten::add", 420, 430)]
    return trace.Summary(device, host, 700e-9, 2, {"lk_dwconv": 2})


def test_busy_counts_and_categories():
    s = _summary()
    assert s.busy_s == pytest.approx((150 + 100 + 100) * 1e-9)
    assert s.kernel("lk_dwconv_kernel") == (pytest.approx(200e-9), 2)
    assert s.kernels == 3  # copies and sets are not kernels
    assert s.by_category["memcpy"][1] == 1
    assert s.by_category["batch norm"][1] == 1
    assert trace.category("sm90_xmma_gemm_bf16") == trace.LIBRARY
    assert trace.category("void ffn_gemm_kernel<128>") == "kernel B"


def test_gaps_labelled_by_span_and_innermost_op():
    gaps = _summary().gaps()
    assert gaps == {"predict_depth/aten::cudnn_convolution": pytest.approx(150e-9),
                    "predict_depth/python": pytest.approx(100e-9)}


def test_idle_share():
    s = _summary()
    ctx = Context.__new__(Context)
    ctx.summary = s
    assert ctx.idle() == pytest.approx(100 * (1 - 350 / 700))


def _teacher_context(launches_a_unit, units=2):
    cell = cells.cell("cs-dc-serve-teacher-b32")
    p = {"pass": "teacher", "batch": 32, "form": "merged", "dtype": "bf16"}
    device = [("void lk_dwconv_kernel<bf16, 31>", 1000 * i, 1000 * i + 500)
              for i in range(launches_a_unit * units)]
    s = trace.Summary(device, [], 1e-3, units, {"lk_dwconv": launches_a_unit * units})
    return Context(s, {"units": units, "seconds": 1.0},
                   lambda: model_pass.count(cell["config"], [p]), [p])


def test_roofline_reads_the_reference_shapes():
    """24 launches a teacher request, as the reference's shapes give:
    the bounds of those 24 convs over the traced device time."""
    ctx = _teacher_context(24)
    due = ctx.launches("lk_dwconv")
    mod = cells.load_module("roofline", "lk_dwconv")
    bound = 2 * sum(peaks.bound_s(*mod.work(*a), d) for d, a in due)
    assert ctx.roofline("lk_dwconv") == pytest.approx(100 * bound / (48 * 500e-9))
    assert ctx.roofline("plane_sweep") is None  # neither ran nor was due


def test_roofline_launch_mismatch_fails_the_run():
    """A kernel launched another number of times than the reference's
    shapes give fails the run rather than dropping its reading."""
    ctx = _teacher_context(23)
    with pytest.raises(RuntimeError, match="lk_dwconv"):
        ctx.roofline("lk_dwconv")
