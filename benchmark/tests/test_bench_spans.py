"""The program's spans on a hand-made trace: the device idle inside the
harness's spans split by the innermost `ppea:` host range open, instant
by instant; a range's device-side copy not taken for a host range. On a
card (`-m gpu`): two traced student requests give each
range once a request, on the device events' clock, and the three
readers read numbers that sum to the idle gaps."""

import pytest

import run
from harness import cells, program, spans, trace, weights
from harness.layers import Context

READERS = ("idle_dispatch_ms.serve", "idle_session_ms.serve",
           "idle_caller_ms.serve")


def _summary(units=1):
    # device: upload copy, pose kernels, encoder kernel, download copy;
    # then the next request's upload copy
    device = [("Memcpy HtoD (Pageable -> Device)", 100, 120),
              ("implicit_gemm_f32", 200, 230), ("fft_pointwise", 240, 260),
              ("void lk_dwconv_kernel<bf16, 31>", 300, 400),
              ("Memcpy DtoH (Device -> Pageable)", 430, 450),
              ("Memcpy HtoD (Pageable -> Device)", 700, 720)]
    host = [("bench:predict_depth_multi", 0, 600),
            ("ppea:serve.request", 10, 590),
            ("ppea:serve.upload", 20, 150),
            ("ppea:model.pose", 160, 250),
            ("ppea:model.pose", 200, 260),  # its device-side copy
            ("ppea:model.student_encoder", 250, 380),
            ("ppea:serve.download", 420, 580),
            ("bench:predict_depth_multi", 620, 800),
            ("ppea:serve.request", 630, 790),
            ("ppea:serve.upload", 640, 760),
            ("aten::copy_", 425, 455)]
    return trace.Summary(device, host, 800e-9, units, {})


def _ctx(summary):
    ctx = Context.__new__(Context)
    ctx.summary = summary
    return ctx


def test_device_side_copies_are_not_host_ranges():
    host = spans.ranges(_summary())
    assert [r for r in host if r[0] == "model.pose"] == [("model.pose", 160, 250)]
    assert len(host) == 7


def test_gaps_split_by_overlap():
    """Gaps 120-200 (upload, request, pose), 230-240 (pose), 260-300
    (encoder), 400-430 (request, download) and 450-700: download to 580,
    request to 590, the caller to 630, request to 640, upload; the last
    is shared by overlap, not given wholly to the download open at its
    start."""
    split = spans.idle_split(_summary())
    session = 30 + 10 + 20 + 10 + 130 + 10 + 10 + 60
    assert split == {"session": pytest.approx(session * 1e-9),
                     "dispatch": pytest.approx((40 + 10 + 40) * 1e-9),
                     "caller": pytest.approx(40e-9)}


def test_three_parts_sum_to_the_idle_inside_harness_spans():
    s = _summary()
    split = spans.idle_split(s)
    assert sum(split.values()) == pytest.approx(sum(s.gaps().values()))
    assert sum(split.values()) == pytest.approx(
        (80 + 10 + 40 + 30 + 250) * 1e-9)


def test_readers():
    ctx = _ctx(_summary(units=2))
    got = {m: cells.load_module("metrics", m).read(ctx) for m in READERS}
    assert got["idle_dispatch_ms.serve"] == pytest.approx(1e3 * 90e-9 / 2)
    assert got["idle_session_ms.serve"] == pytest.approx(1e3 * 280e-9 / 2)
    assert got["idle_caller_ms.serve"] == pytest.approx(1e3 * 40e-9 / 2)


def test_readers_read_nothing_without_the_program_spans():
    """A program that opens no `ppea:` range (the benchmark's older
    program) gives no reading, and no error."""
    s = _summary()
    host = [h for h in s.host if not h[0].startswith("ppea:")]
    bare = trace.Summary(s.device, host, s.window_s, 1, {})
    assert all(cells.load_module("metrics", m).read(_ctx(bare)) is None
               for m in READERS)


@pytest.mark.gpu
def test_traced_student_requests_on_the_card(cuda):
    """Two student requests traced as the harness traces them: the
    profiler's device-side copies of the ranges (kineto's events, before
    the reduction) end on device events and start after their host
    ranges, on the one clock; the reduced trace gives each host range
    once a request, with each upload's copies to the device inside it,
    and the three readers read numbers that sum to the idle gaps."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cell = cells.cell("kitti-serve-student-b32")
    port = program.port()
    port["kernels"].build.library()
    seed = 5_000_000_019
    sd = weights.state_dict(cell["config"], program.sub_seed(seed, 0), "cuda")
    loop = run.make_loop(port, cell, sd, seed, "cuda")
    loop.warm_up(0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            with record_function(trace.SPAN + loop.unit_name):
                loop.unit()
        torch.cuda.synchronize()
    device, host_events = trace.events(prof)
    summary = trace.Summary(device, host_events, 1.0, 2, {})
    host = spans.ranges(summary)
    names = [n for n, _, _ in host]
    assert {names.count(n) for n in names} == {2}, names
    assert set(names) == {"serve.request", "serve.upload", "model.pose",
                          "model.student_encoder", "model.cost_volume",
                          "model.decoder", "serve.download"}

    starts, ends = {a for _, a, _ in device}, {b for _, _, b in device}
    copies = [(e.name()[len(spans.PREFIX):], e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith(spans.PREFIX)
              and "CUDA" in str(e.device_type())]
    assert {n for n, _, _ in copies} >= {"model.pose", "serve.upload"}, copies
    for name, a, b in copies:
        assert a in starts and b in ends, (name, a, b)
        mine = [s for n, s, _ in host if n == name]
        before = [s for s in mine if s <= a]
        assert before, (name, a, mine)
        assert all(s > a for s in mine[len(before):]), (name, a, mine)
    for _, s, e in (r for r in host if r[0] == "serve.upload"):
        assert any(n.startswith("Memcpy HtoD") and s <= a and b <= e
                   for n, a, b in device), (s, e)

    ctx = Context(summary, {"units": 2, "seconds": 1.0}, None, loop.passes())
    got = {m: cells.load_module("metrics", m).read(ctx) for m in READERS}
    assert all(isinstance(v, float) and v >= 0 for v in got.values()), got
    assert sum(got.values()) == pytest.approx(
        1e3 * sum(summary.gaps().values()) / 2)
