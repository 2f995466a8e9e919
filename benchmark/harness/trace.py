"""Reduce a torch.profiler trace of the traced units to what the
per-layer readers take: device time by kernel name and by category,
kernel counts, device busy time (the union of device intervals), the
traced span, and the idle gaps labelled by what the host was doing.

The harness wraps each call it makes into the program in a
`record_function` span named `bench:<call>`; an idle gap is labelled by
that span and the innermost operator open on the host when it began
("python" where none was)."""

from __future__ import annotations

from bisect import bisect_right

SPAN = "bench:"
DEVICE_KINDS = {"kernel", "gpu_memcpy", "gpu_memset"}

# the device-time categories (first match of a lower-cased kernel name)
_CATEGORIES = (
    ("lk_dwconv", "kernel A"), ("ffn_", "kernel B"),
    ("plane_sweep", "kernel C"), ("warp_fwd_kernel", "kernel D"),
    ("warp_bwd_kernel", "kernel D"), ("memcpy htod", "memcpy"),
    ("memcpy dtoh", "memcpy"), ("memcpy", "memcpy"), ("memset", "memset"),
    ("reflection_pad", "reflection pad"), ("batch_norm", "batch norm"),
    ("bn_fw", "batch norm"), ("bn_bw", "batch norm"),
    ("adam", "Adam"), ("multi_tensor", "Adam"), ("upsample", "upsample and cat"),
    ("catarray", "upsample and cat"), ("reduce", "reductions"),
    ("index", "gather and index"), ("max_pool", "max pool"))
_LIBRARY = ("conv", "gemm", "xmma", "cutlass", "cudnn", "nchw", "nhwc",
            "implicit", "sm90", "winograd")
LIBRARY = "cuDNN and cuBLAS"
ELEMENTWISE = "other elementwise"


def category(name: str) -> str:
    n = name.lower()
    for key, cat in _CATEGORIES:
        if key in n:
            return cat
    if any(k in n for k in _LIBRARY):
        return LIBRARY
    return ELEMENTWISE


def events(prof):
    """(device, host) event lists of a finished profile: (name, start_ns,
    end_ns) each. Device: kernels, copies and sets (the profiler's own
    annotations left out); host: operators, CUDA runtime calls and the
    harness's spans."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        ev = (name, e.start_ns(), e.end_ns())
        on_device = "CUDA" in str(e.device_type())
        if hasattr(e, "activity_type"):
            kind = str(e.activity_type())
            on_device, annotation = kind in DEVICE_KINDS, kind.endswith("annotation")
        else:  # older torch: annotations by flag, or by their "#" names
            annotation = (e.is_user_annotation() if hasattr(e, "is_user_annotation")
                          else name.startswith(SPAN) or "#" in name)
        if on_device and not annotation:
            device.append(ev)
        elif not on_device:
            host.append(ev)
    return device, host


def union_ns(intervals):
    """Merged [start, end) segments of the intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class Summary:
    """The traced units' device work. `device`, `host`: (name, start_ns,
    end_ns) lists; `window_s`: the traced span on the host clock;
    `units`: steps or requests traced; `counts`: the program's launch
    counters over the same units."""

    def __init__(self, device, host, window_s, units, counts):
        self.device, self.host = device, host
        self.window_s, self.units, self.counts = window_s, units, counts
        self.segments = union_ns([(s, e) for _, s, e in device])
        self.busy_s = sum(e - s for s, e in self.segments) / 1e9
        self.by_name, self.by_category = {}, {}
        for name, s, e in device:
            for acc, key in ((self.by_name, name), (self.by_category, category(name))):
                t = acc.setdefault(key, [0.0, 0])
                t[0] += (e - s) / 1e9
                t[1] += 1
        self.kernels = sum(1 for n, _, _ in device
                           if not n.lower().startswith(("memcpy", "memset")))

    def kernel(self, trace_name: str):
        """(seconds, events) of the device events whose name holds
        `trace_name`."""
        t, n = 0.0, 0
        for name, (sec, cnt) in self.by_name.items():
            if trace_name in name:
                t, n = t + sec, n + cnt
        return t, n

    def gaps(self):
        """{label: idle seconds} over the gaps between device segments
        inside the harness's spans."""
        spans = sorted((s, e, n[len(SPAN):]) for n, s, e in self.host
                       if n.startswith(SPAN))
        ops = sorted((s, e, n) for n, s, e in self.host if not n.startswith(SPAN))
        starts = [s for s, _, _ in ops]
        out = {}
        for (_, a), (b, _) in zip(self.segments, self.segments[1:]):
            span = next((n for s, e, n in spans if s <= a < e), None)
            if span is None:
                continue
            inner = "python"
            # the innermost operator open at `a`: the latest-starting one
            last = bisect_right(starts, a) - 1
            for i in range(last, max(-1, last - 400), -1):
                s, e, n = ops[i]
                if e > a:
                    inner = n
                    break
            label = f"{span}/{inner}"
            out[label] = out.get(label, 0.0) + (b - a) / 1e9
        return out

    def breakdown(self):
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(self.gaps().items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, v[0]] for n, v in top],
                "idle_gaps": [[n, v] for n, v in gaps]}
