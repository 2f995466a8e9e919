"""Kernel B (`ffn_gemm_kernel`, launched twice a call: up and down): the
merged ConvFFN with its adapter folded in, in serving.

Operations: the two GEMMs with the adapter's, 2 M C (2 x hidden + 2 x
adapter) (the hidden width unpadded). Bytes: the activations in and out,
the weights and the f32 biases, once each."""

TRACE_NAMES = ("ffn_gemm_kernel",)
COUNTERS = {"ffn_fused": 2}
ITEMSIZE = {"bf16": 2, "f32": 4}


def work(M, C, hidden, adapter, itemsize):
    flop = 2 * M * C * (2 * hidden + 2 * adapter)
    nbytes = (itemsize * 2 * M * C + itemsize * 2 * C * (hidden + adapter)
              + 4 * (hidden + C + adapter + C))
    return flop, nbytes


def launches(calls, p):
    """One call a ConvFFN of the merged form (its two launches' work
    together); the training form runs no kernel B."""
    if p["form"] != "merged":
        return []
    out = []
    for c in calls:
        if c["site"] == "ConvFFN":
            B, C, H, W = c["x"]
            out.append((p["dtype"], (B * H * W, C, c["hidden"], c["adapter"],
                                     ITEMSIZE[p["dtype"]])))
    return out
