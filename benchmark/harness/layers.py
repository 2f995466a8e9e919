"""What a per-layer reader (`metrics/<name>.py`, a `read(ctx)` that
returns a number or None) is given: the traced units' summary, the
window's units and seconds, the model FLOPs of a unit, and each kernel's
share of its roofline."""

from __future__ import annotations

from . import cells, peaks

KERNELS = ("lk_dwconv", "ffn_fused", "plane_sweep", "warp_border")


class Context:
    def __init__(self, summary, window, count, passes):
        """`count()` gives (model FLOPs of a unit, each pass's site calls)
        from `harness/model_pass.py`; `passes` is the loop's `passes()`."""
        self.summary, self.window = summary, window
        self._count, self.passes = count, passes

    def per_unit(self, seconds: float) -> float:
        return seconds / self.summary.units

    def category_s(self, *names) -> float:
        return sum(self.summary.by_category.get(n, [0.0])[0] for n in names)

    def assert_counts(self):
        """Each kernel's device events in the traced units equal the
        program's launch counters over the same units; a trace that
        dropped kernels gives no reading."""
        for k in KERNELS:
            mod = cells.load_module("roofline", k)
            want = sum(self.summary.counts.get(c, 0) * m
                       for c, m in mod.COUNTERS.items())
            got = sum(self.summary.kernel(t)[1] for t in mod.TRACE_NAMES)
            if got != want:
                raise RuntimeError(f"trace holds {got} {k} launches, the "
                                   f"program counted {want}")

    def launches(self, kernel: str) -> list:
        """(dtype, args of `work`) of each of the kernel's launches in one
        unit, worked out by `roofline/<kernel>.py` from the reference's
        calls at the cell's shapes."""
        mod = cells.load_module("roofline", kernel)
        calls = self._count()[1]
        return [x for p, c in zip(self.passes, calls) for x in mod.launches(c, p)]

    def roofline(self, kernel: str):
        """Percent: the sum of the traced launches' bounds over their
        device time; None where the kernel neither ran nor was due. A
        kernel that ran another number of times than the reference's
        calls give fails the run: its bounds would not be its work."""
        mod = cells.load_module("roofline", kernel)
        seconds = sum(self.summary.kernel(t)[0] for t in mod.TRACE_NAMES)
        ran = sum(self.summary.counts.get(c, 0) for c in mod.COUNTERS)
        due = self.launches(kernel)
        if ran != len(due) * self.summary.units:
            raise RuntimeError(
                f"{kernel}: the program launched {ran} times in "
                f"{self.summary.units} units, the reference's shapes give "
                f"{len(due)} a unit")
        if not ran:
            return None
        bound = sum(peaks.bound_s(*mod.work(*args), dtype)
                    for dtype, args in due) * self.summary.units
        return 100.0 * bound / seconds

    def mfu(self):
        """Percent of the bf16 dense peak: the model FLOPs of the window's
        units over the window's seconds."""
        w = self.window
        return (100.0 * self._count()[0] * w["units"]
                / (w["seconds"] * peaks.MFU_FLOP_PER_S))

    def idle(self):
        return 100.0 * (1.0 - self.summary.busy_s / self.summary.window_s)
