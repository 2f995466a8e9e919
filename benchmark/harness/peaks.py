"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W):
operations a second by operand type, and HBM bytes a second. A float32
operand takes the TF32 tensor rate, the highest the card has for it, so
no implementation of a kernel, a tensor-core one included, can read over
100 % of its roofline."""

FLOP_PER_S = {"bf16": 989e12, "f32": 495e12}
MFU_FLOP_PER_S = 989e12   # the whole step's share: the bf16 dense peak
HBM_BYTES_PER_S = 3.35e12


def bound_s(flop: float, nbytes: float, dtype: str) -> float:
    """Least time for the work: the larger of bytes over the memory rate
    and operations over the peak of the operand type."""
    return max(nbytes / HBM_BYTES_PER_S, flop / FLOP_PER_S[dtype])
