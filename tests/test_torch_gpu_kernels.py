"""Port kernels on the card: each hand-written CUDA kernel against its plain
PyTorch version, at the teacher's B=8 640x192 stage shapes of RepLKNet-31B
and at ragged edge shapes.

Marked `gpu`; every test skips without a CUDA device. Run on a card with
`python -m pytest -m gpu tests/test_torch_gpu_kernels.py -q`.

Both sides take the same bf16 inputs; the plain version runs on their f32
upcast with TF32 off, so the error is the kernel's own (bf16 output
rounding, f32 summation order).
"""

import numpy as np
import pytest
import torch

from ppeadepth_tpu_torch import kernels
from ppeadepth_tpu_torch.kernels.ffn_fused import (
    FoldedFFN, ffn_fused, ffn_fused_plain)
from ppeadepth_tpu_torch.kernels.lk_conv import depthwise_plain, lk_depthwise
from ppeadepth_tpu_torch.models.replknet import REPLK_CONFIGS

pytestmark = pytest.mark.gpu

_B = REPLK_CONFIGS["b"]
# (C, H, W, k) of the four encoder stages at B=8, 640x192
STAGES = [(_B["channels"][i], 192 // 4 >> i, 640 // 4 >> i,
           _B["large_kernel_sizes"][i]) for i in range(4)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16(rng, shape, scale, device):
    return torch.from_numpy(
        (rng.randn(*shape) * scale).astype(np.float32)).to(device).bfloat16()


@pytest.mark.parametrize("B,C,H,W,k,bias", [
    (8, *STAGES[0], True), (8, *STAGES[1], True), (8, *STAGES[2], True),
    (8, *STAGES[3], True),
    (3, 48, 7, 19, 5, False),    # C not a multiple of 32, ragged tiles
    (2, 20, 9, 21, 7, True),     # C not a multiple of 8: scalar halo loads
    (2, 32, 5, 9, 13, True),     # k > H and k > W
])
def test_lk_dwconv_matches_plain(cuda, B, C, H, W, k, bias):
    rng = np.random.RandomState(0)
    x = _bf16(rng, (B, H, W, C), 1.0, cuda).permute(0, 3, 1, 2)
    w = _bf16(rng, (C, 1, k, k), 1.0 / k, cuda)
    b = _bf16(rng, (C,), 0.1, cuda) if bias else None
    n0 = kernels.launch_counts["lk_dwconv"]
    y = lk_depthwise(x, w, b)
    torch.cuda.synchronize()
    assert kernels.launch_counts["lk_dwconv"] == n0 + 1
    assert y.is_contiguous(memory_format=torch.channels_last)
    ref = depthwise_plain(x.float(), w.float(),
                          b.float() if b is not None else None)
    # bf16 output rounding is <= 2^-9 relative; 1e-2 of the peak leaves
    # room for f32 summation order over up to 961 taps
    err = (y.float() - ref).abs().max().item()
    assert err <= 1e-2 * ref.abs().max().item(), err


@pytest.mark.parametrize("C,M,adapter", [
    (STAGES[0][0], 8 * STAGES[0][1] * STAGES[0][2], True),
    (STAGES[1][0], 8 * STAGES[1][1] * STAGES[1][2], True),
    (STAGES[2][0], 8 * STAGES[2][1] * STAGES[2][2], True),
    (STAGES[3][0], 8 * STAGES[3][1] * STAGES[3][2], True),
    (STAGES[0][0], 8 * STAGES[0][1] * STAGES[0][2], False),
    (STAGES[2][0], 8 * STAGES[2][1] * STAGES[2][2], False),  # split, no adapter
    (256, 100, True),            # ragged M (not a multiple of 32 rows)
])
def test_ffn_fused_matches_plain(cuda, C, M, adapter):
    rng = np.random.RandomState(1)
    H4, CA = 4 * C, C // 4
    p = FoldedFFN(
        _bf16(rng, (C, H4), C ** -0.5, cuda),
        torch.from_numpy(rng.randn(H4).astype(np.float32) * 0.1).to(cuda),
        _bf16(rng, (H4, C), H4 ** -0.5, cuda),
        torch.from_numpy(rng.randn(C).astype(np.float32) * 0.1).to(cuda),
        *((_bf16(rng, (C, CA), C ** -0.5, cuda),
           torch.from_numpy(rng.randn(CA).astype(np.float32) * 0.1).to(cuda),
           _bf16(rng, (CA, C), CA ** -0.5, cuda),
           torch.from_numpy(rng.randn(C).astype(np.float32) * 0.1).to(cuda))
          if adapter else ()))
    x = _bf16(rng, (1, 1, M, C), 1.0, cuda).permute(0, 3, 1, 2)
    n0 = kernels.launch_counts["ffn_fused"]
    y = ffn_fused(x, p)
    torch.cuda.synchronize()
    assert kernels.launch_counts["ffn_fused"] == n0 + 1
    pf = FoldedFFN(*(t.float() if t is not None else None for t in p))
    ref = ffn_fused_plain(x.float().permute(0, 2, 3, 1).reshape(M, C), pf)
    got = y.float().permute(0, 2, 3, 1).reshape(M, C)
    # the JAX fused-kernel test's bounds (tests/test_ffn_mxu.py:63-67):
    # bf16 operands and the bf16-rounded hidden
    scale = ref.abs().max().item()
    diff = (got - ref).abs()
    assert diff.max().item() / scale < 2.5e-2
    assert diff.mean().item() / scale < 3e-3


def test_wrappers_raise_on_cuda_float32(cuda):
    x = torch.zeros(1, 32, 4, 4, device=cuda).to(memory_format=torch.channels_last)
    w = torch.zeros(32, 1, 3, 3, device=cuda)
    with pytest.raises(TypeError):
        lk_depthwise(x, w)
