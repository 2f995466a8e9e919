"""Kernel A (`lk_dwconv_kernel`): the stride-1 SAME depthwise convs of the
RepLKNet blocks, forward and (training) the input gradient.

Operations: two per multiply-add a SAME conv needs once taps that fall on
the zero padding are dropped. Bytes: the input and output once each, and
the weights once."""

TRACE_NAMES = ("lk_dwconv_kernel",)
COUNTERS = {"lk_dwconv": 1, "lk_dwconv_dx": 1}  # device launches a count
ITEMSIZE = {"bf16": 2, "f32": 4}


def _taps(n, k):
    h = k // 2
    return sum(min(n - 1, o + h) - max(0, o - h) + 1 for o in range(n))


def work(B, C, H, W, k, itemsize):
    flop = 2 * B * C * _taps(H, k) * _taps(W, k)
    nbytes = itemsize * (2 * B * C * H * W + C * k * k)
    return flop, nbytes


def launches(calls, p):
    """(dtype, args of `work`) of each launch in one pass `p` of
    `harness/model_pass.py`, from its `ReparamLKConv` calls. The merged
    form folds a block's large and small kernels into one conv, launched
    once; the training form launches each, and again for the input
    gradient where the input needs it."""
    out = []
    for c in calls:
        if c["site"] != "ReparamLKConv":
            continue
        B, C, H, W = c["x"]
        if p["form"] == "merged":
            ks = [c["k"]]
        else:
            ks = [c["k"], c["small_k"]] * (2 if c["grad"] else 1)
        out += [(p["dtype"], (B, C, H, W, k, ITEMSIZE[p["dtype"]])) for k in ks]
    return out
