"""Port kernels on the card: each hand-written CUDA kernel against its plain
PyTorch version, at the B=8 640x192 shapes of RepLKNet-31B (the stages of
kernels A and B, the student's plane sweep for kernel C), at the training
step's shapes (kernel A in f32 and as kernel #2's forward and dx, kernel
D's photometric warp and its coordinate gradient), at the eval forward's
shapes of kernel #3 (kernel A under --lk_backend pallas) and at ragged edge
shapes.

Marked `gpu`; every test skips without a CUDA device. Run on a card with
`python -m pytest -m gpu tests/test_torch_gpu_kernels.py -q`.

Both sides take the same inputs; the plain version runs on their f32
upcast with TF32 off, so the error is the kernel's own (bf16 output
rounding, f32 summation order).
"""

import numpy as np
import pytest
import torch

from ppeadepth_tpu_torch import kernels
from ppeadepth_tpu_torch.kernels.cost_volume import plane_sweep, plane_sweep_plain
from ppeadepth_tpu_torch.kernels.ffn_fused import (
    FoldedFFN, ffn_fused, ffn_fused_plain)
from ppeadepth_tpu_torch.kernels.lk_conv import (
    depthwise_plain, lk_depthwise, lk_depthwise_train)
from ppeadepth_tpu_torch.kernels.warp import warp_border, warp_border_plain
from ppeadepth_tpu_torch.models.replknet import REPLK_CONFIGS
from ppeadepth_tpu_torch.ops.cost_volume import compute_depth_bins, project

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


# kernel #3 (the Pallas depthwise_conv2d_pallas) at the eval forward's
# shapes under --lk_backend pallas: the stem's stride-1 3x3 at 96x320 and
# each stage's large kernel and k=5, at a partial last eval batch (B=5)
LK_PALLAS = [(128, 96, 320, 3), *STAGES, *((C, H, W, 5) for C, H, W, _ in STAGES)]


@pytest.mark.parametrize("C,H,W,k", LK_PALLAS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lk_pallas_shapes_match_plain(cuda, dtype, C, H, W, k):
    """Kernel A without bias against cuDNN: f32 within 1e-5 of the peak
    (summation order only), bf16 within 1e-2 (output rounding)."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(5, H, W, C).astype(np.float32)).to(
        cuda, dtype).permute(0, 3, 1, 2)
    w = torch.from_numpy((rng.randn(C, 1, k, k) / k).astype(np.float32)).to(
        cuda, dtype)
    y = lk_depthwise(x, w)
    torch.cuda.synchronize()
    ref = depthwise_plain(x.float(), w.float())
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    err = (y.float() - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item(), err


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
    """Kernel A takes f32 now, but only with f32 weights: a mixed pair
    raises instead of falling back."""
    x = torch.zeros(1, 32, 4, 4, device=cuda).to(memory_format=torch.channels_last)
    w = torch.zeros(32, 1, 3, 3, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        lk_depthwise(x, w)
    with pytest.raises(TypeError):
        lk_depthwise(x.half(), w.half())


def _t(rng, shape, scale, device, dtype):
    return torch.from_numpy(
        (rng.randn(*shape) * scale).astype(np.float32)).to(device).to(dtype)


@pytest.mark.parametrize("C,H,W,k", [*(s for s in STAGES), (20, 9, 21, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lk_train_matches_plain(cuda, dtype, C, H, W, k):
    """Kernel #2: forward (kernel A, no bias) and d/dx (kernel A on the
    flipped kernel) through the autograd Function, at the training stage
    shapes (B=2) and a ragged one. bf16 as kernel A's test; f32 within
    1e-4 of the peak (f32 summation order over up to 961 taps)."""
    rng = np.random.RandomState(k)
    x = _t(rng, (2, H, W, C), 1.0, cuda, dtype).permute(0, 3, 1, 2)
    g = _t(rng, (2, H, W, C), 1.0, cuda, dtype).permute(0, 3, 1, 2)
    w = _t(rng, (C, 1, k, k), 1.0 / k, cuda, dtype)
    x.requires_grad_(True)
    n0 = dict(kernels.launch_counts)
    y = lk_depthwise_train(x, w)
    y.backward(g)
    torch.cuda.synchronize()
    assert kernels.launch_counts["lk_dwconv"] == n0["lk_dwconv"] + 1
    assert kernels.launch_counts["lk_dwconv_dx"] == n0["lk_dwconv_dx"] + 1
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    for got, ref in ((y, depthwise_plain(x.detach().float(), w.float())),
                     (x.grad, depthwise_plain(g.float(), w.flip(-1, -2).float()))):
        assert got.dtype == dtype
        err = (got.float() - ref).abs().max().item()
        assert err <= tol * ref.abs().max().item(), err


@pytest.mark.parametrize("N,H,W", [(24, 192, 640), (3, 7, 13)])
def test_warp_border_matches_plain(cuda, N, H, W):
    """Kernel D forward within 1e-5 (images in [0, 1]) and its coordinate
    gradient within 1e-5 of the peak, against the plain version's autograd,
    at one branch's training warp and a ragged shape, with coordinates
    beyond the borders."""
    rng = np.random.RandomState(N)
    img = torch.from_numpy(rng.rand(N, H, W, 3).astype(np.float32)).to(cuda)
    coords = torch.from_numpy(rng.uniform(-1.2, 1.2, (N, H, W, 2)).astype(
        np.float32)).to(cuda)
    g = torch.from_numpy(rng.randn(N, H, W, 3).astype(np.float32)).to(cuda)
    n0 = dict(kernels.launch_counts)
    c = coords.clone().requires_grad_(True)
    out = warp_border(img, c)
    out.backward(g)
    torch.cuda.synchronize()
    assert kernels.launch_counts["warp_fwd"] == n0["warp_fwd"] + 1
    assert kernels.launch_counts["warp_bwd"] == n0["warp_bwd"] + 1
    cp = coords.clone().requires_grad_(True)
    ref = warp_border_plain(img, cp)
    ref.backward(g)
    assert (out - ref).abs().max().item() <= 1e-5
    assert (c.grad - cp.grad).abs().max().item() <= 1e-5 * cp.grad.abs().max().item()


def _sweep_inputs(rng, B, C, H, W, D, dtype, device, zero_pose=False):
    """Features, (A, t) of a non-degenerate pose (small rotation, x+y+z
    translation) under KITTI-style intrinsics at H x W, and log bins."""
    def feats():
        return torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32)).to(
            device).to(dtype).permute(0, 3, 1, 2)

    K = np.array([[0.58 * W, 0, 0.5 * W], [0, 1.92 * H, 0.5 * H], [0, 0, 1]])
    A = np.zeros((B, 3, 3), np.float32)
    t = np.zeros((B, 3), np.float32)
    if not zero_pose:
        for b in range(B):
            th = rng.randn(3) * 0.02
            c, s = np.cos(th), np.sin(th)
            R = (np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
                 @ np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
                 @ np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]]))
            A[b] = K @ R @ np.linalg.inv(K)
            t[b] = K @ (rng.randn(3) * [0.05, 0.03, 0.1] + [0.1, 0.02, 0.05])
    bins = compute_depth_bins(0.1, 10.0, D, device=device)
    return (feats(), feats(), torch.from_numpy(A).to(device),
            torch.from_numpy(t).to(device), bins)


def _near_boundary(A, t, bins, H, W):
    """Samples within 1e-4 px of an edge-mask boundary (plain coordinates)."""
    x, y = project(A, t, bins, H, W)
    d = torch.minimum(torch.minimum((x - 2).abs(), (x - (W - 2)).abs()),
                      torch.minimum((y - 2).abs(), (y - (H - 2)).abs()))
    return (d < 1e-4).reshape(A.shape[0], -1, H, W)


@pytest.mark.parametrize("B,C,H,W,D", [
    (8, 128, 48, 160, 96),       # the student's main path, 640x192
    (2, 16, 13, 27, 40),         # H*W not a multiple of 8 pixels, D of 32
    (1, 256, 11, 21, 33),        # the widest C, two channel groups a lane
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plane_sweep_matches_plain(cuda, B, C, H, W, D, dtype):
    """Within 5e-5 of the peak (the JAX mxu_f32 check's bound), at most
    one entry in 1e5 beyond it and each at a mask boundary; bf16 inputs
    against the plain version on the same bf16 values."""
    rng = np.random.RandomState(C + D)
    cur, lk, A, t, bins = _sweep_inputs(rng, B, C, H, W, D, dtype, cuda)
    n0 = kernels.launch_counts["plane_sweep"]
    y = plane_sweep(cur, lk, A, t, bins)
    torch.cuda.synchronize()
    assert kernels.launch_counts["plane_sweep"] == n0 + 1
    assert y.shape == (B, D, H, W) and y.dtype == torch.float32
    assert y.is_contiguous(memory_format=torch.channels_last)
    ref = plane_sweep_plain(cur, lk, A, t, bins)
    assert (ref > 0).float().mean().item() > 0.1
    beyond = (y - ref).abs() > 5e-5 * ref.abs().max()
    near = _near_boundary(A, t, bins, H, W)
    assert beyond.sum().item() <= beyond.numel() // 100000
    assert not (beyond & ~near).any()


def test_plane_sweep_zero_pose(cuda):
    rng = np.random.RandomState(5)
    args = _sweep_inputs(rng, 2, 128, 12, 40, 96, torch.bfloat16, cuda,
                         zero_pose=True)
    assert (plane_sweep(*args) == 0).all()


def test_plane_sweep_raises_on_unsupported_c(cuda):
    rng = np.random.RandomState(6)
    args = _sweep_inputs(rng, 1, 12, 8, 16, 8, torch.float32, cuda)
    with pytest.raises(ValueError):
        plane_sweep(*args)
