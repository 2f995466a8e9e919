"""Kernel C (`plane_sweep_kernel`): the per-bin edge-masked L1 differences
of the cost volume, one launch a lookup frame.

Operations: per (item, bin, pixel) 12 for the projection, and per
channel of each sample 12 (the bilinear blend 9, the difference, its
absolute value, the sum), counted for every sample, masked or not, at
the f32 rate (the kernel computes in f32 whatever its features' type).
Bytes: both feature maps read once, the f32 differences written once."""

TRACE_NAMES = ("plane_sweep_kernel",)
COUNTERS = {"plane_sweep": 1}
ITEMSIZE = {"bf16": 2, "f32": 4}


def work(B, C, H, W, D, itemsize, samples=None):
    samples = B * D * H * W if samples is None else samples
    flop = 12 * C * samples + 12 * B * D * H * W
    nbytes = 2 * B * H * W * C * itemsize + 4 * B * D * H * W
    return flop, nbytes


def launches(calls, p):
    """One launch a `plane_sweep` call, on features of the pass's type."""
    return [("f32", (*c["cur"], c["bins"], ITEMSIZE[p["dtype"]]))
            for c in calls if c["site"] == "plane_sweep"]
