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
from ppeadepth_tpu_torch.kernels.cost_volume import (
    SweepPlan, _launch, plane_sweep, plane_sweep_plain)
from ppeadepth_tpu_torch.kernels.ffn_fused import (
    FoldedFFN, ffn_fused, ffn_fused_plain)
from ppeadepth_tpu_torch.kernels.lk_conv import (
    _input_grad, depthwise_plain, lk_depthwise, lk_depthwise_train)
from ppeadepth_tpu_torch.kernels.warp import warp_border, warp_border_plain
from ppeadepth_tpu_torch.kernels.ffn_fused import fold_ffn_params
from ppeadepth_tpu_torch.models.replknet import REPLK_CONFIGS, ConvFFN
from ppeadepth_tpu_torch.options import Config
from ppeadepth_tpu_torch.serve import InferenceSession
from ppeadepth_tpu_torch.ops.cost_volume import compute_depth_bins, project

pytestmark = pytest.mark.gpu

_B = REPLK_CONFIGS["b"]
# (C, H, W, k) of the four encoder stages at B=8, 640x192
STAGES = [(_B["channels"][i], 192 // 4 >> i, 640 // 4 >> i,
           _B["large_kernel_sizes"][i]) for i in range(4)]
# (C, H, W, k) of the stage-2 step's large-kernel convs at 192x512 (the
# CityScapes preset): each stage's large kernel and the small k=5
STAGES_CS = [(C, 192 // 4 >> i, 512 // 4 >> i, k)
             for i, (C, _, _, lk) in enumerate(STAGES)
             for k in (lk, _B["small_kernel"])]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(rng, shape, scale, device, dtype):
    return torch.from_numpy(
        (rng.randn(*shape) * scale).astype(np.float32)).to(device).to(dtype)


def _bf16(rng, shape, scale, device):
    return torch.from_numpy(
        (rng.randn(*shape) * scale).astype(np.float32)).to(device).bfloat16()


# every k with its own instance of kernel A (3, 5, 7: wide; 13, 27, 29, 31:
# narrow) and k=9 (the run-time-k instance), at a stage-like shape
LK_KS = (3, 5, 7, 9, 13, 27, 29, 31)
# ragged: C not a multiple of 8 (scalar halo loads), C odd (scalar stores),
# B=1, H and W no multiple of the tile, k beyond H and W
LK_RAGGED = [(1, 20, 9, 21, 7), (2, 7, 9, 21, 5), (1, 20, 9, 21, 27),
             (3, 48, 7, 19, 13), (2, 32, 5, 9, 13), (1, 13, 11, 23, 9)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,C,H,W,k,bias", [
    (8, *STAGES[0], True), (8, *STAGES[1], True), (8, *STAGES[2], True),
    (8, *STAGES[3], True),
    (3, 48, 7, 19, 5, False),    # C not a multiple of 32, ragged tiles
    (2, 20, 9, 21, 7, True),     # C not a multiple of 8: scalar halo loads
    (2, 32, 5, 9, 13, True),     # k > H and k > W
    *((2, 64, 12, 40, k, True) for k in LK_KS),
    *((*r, True) for r in LK_RAGGED),
])
def test_lk_dwconv_matches_plain(cuda, B, C, H, W, k, bias, dtype):
    rng = np.random.RandomState(0)
    x = _t(rng, (B, H, W, C), 1.0, cuda, dtype).permute(0, 3, 1, 2)
    w = _t(rng, (C, 1, k, k), 1.0 / k, cuda, dtype)
    b = _t(rng, (C,), 0.1, cuda, dtype) if bias else None
    n0 = kernels.launch_counts["lk_dwconv"]
    y = lk_depthwise(x, w, b)
    torch.cuda.synchronize()
    assert kernels.launch_counts["lk_dwconv"] == n0 + 1
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert y.dtype == dtype
    ref = depthwise_plain(x.float(), w.float(),
                          b.float() if b is not None else None)
    # bf16 output rounding is <= 2^-9 relative; 1e-2 of the peak leaves
    # room for f32 summation order over up to 961 taps; f32: 1e-4 of the
    # peak, the summation order alone
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    err = (y.float() - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item(), err


def test_lk_dx_launches_kernel_a_once(cuda):
    """d/dx reads the flipped kernel in place: one launch of kernel A and
    no other launch of the port's."""
    rng = np.random.RandomState(1)
    g = _t(rng, (2, 12, 40, 64), 1.0, cuda, torch.bfloat16).permute(0, 3, 1, 2)
    w = _t(rng, (64, 1, 27, 27), 1.0 / 27, cuda, torch.bfloat16)
    n0 = dict(kernels.launch_counts)
    dx = _input_grad(g, w)
    torch.cuda.synchronize()
    assert {n: kernels.launch_counts[n] - n0[n] for n in n0} == {
        n: int(n == "lk_dwconv_dx") for n in n0}
    ref = depthwise_plain(g.float(), w.flip(-1, -2).float())
    assert (dx.float() - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()


# kernel #3 (the Pallas depthwise_conv2d_pallas) at the eval forward's
# shapes under --lk_backend pallas: the stem's stride-1 3x3 at 96x320 and
# each stage's large kernel and k=5, at a partial last eval batch (B=5);
# and at the DDAD eval's 320x480 (stem 160x240, stages 80x120 .. 10x15,
# where the last is shorter than its k=13 and odd in width)
STAGES_DDAD = [(C, 320 // 4 >> i, 480 // 4 >> i, k)
               for i, (C, _, _, k) in enumerate(STAGES)]
LK_PALLAS = [(128, 96, 320, 3), *STAGES, *((C, H, W, 5) for C, H, W, _ in STAGES),
             (128, 160, 240, 3), *STAGES_DDAD,
             *((C, H, W, 5) for C, H, W, _ in STAGES_DDAD)]


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
    (STAGES[2][0], 8 * STAGES[2][1] * STAGES[2][2], False),
    (256, 100, True),            # ragged M (not a multiple of 32 rows)
    (1536, 960, True),           # stage 3 of rep_size l, 640x192
    (2048, 960, True),           # stage 3 of rep_size xl
    (1024, 1000, True),          # M not a multiple of 64 or 128 rows
    (192, 200, True),            # C of 64 but not 128 columns (l, stage 0)
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


@pytest.mark.parametrize("C", [1536, 2048])
def test_merged_convffn_wide_matches_plain(cuda, C):
    """A merged bf16 ConvFFN of rep_size l (C=1536) and xl (C=2048), folded
    and packed by `ConvFFN.fold`, on the kernel against the plain version
    on its f32-folded operands, at the kernel B bounds."""
    torch.manual_seed(C)
    ffn = ConvFFN(C, 4 * C, adpt_test=4, g_ffn=0.7)
    with torch.no_grad():
        for name, t in ffn.state_dict().items():
            if name.endswith("running_var"):
                t.uniform_(0.5, 1.5)
            elif t.is_floating_point():
                t.normal_(0.0, 0.5 if t.dim() == 1 else 1.0 / t[0].numel() ** 0.5)
    pf = fold_ffn_params(ffn.state_dict(), 0.7, dtype=torch.float32)
    ffn = ffn.eval().to(cuda)
    ffn.fold(torch.bfloat16)
    x = torch.randn(2, 6, 20, C).to(cuda).bfloat16().permute(0, 3, 1, 2)
    n0 = kernels.launch_counts["ffn_fused"]
    with torch.inference_mode():
        y = ffn(x)
    torch.cuda.synchronize()
    assert kernels.launch_counts["ffn_fused"] == n0 + 1
    x2d = x.float().permute(0, 2, 3, 1).reshape(-1, C)
    ref = ffn_fused_plain(x2d, FoldedFFN(*(t.to(cuda) if t is not None else None
                                          for t in pf)))
    diff = (y.float().permute(0, 2, 3, 1).reshape(-1, C) - ref).abs()
    scale = ref.abs().max().item()
    assert diff.max().item() / scale < 2.5e-2
    assert diff.mean().item() / scale < 3e-3


def test_merged_float32_session_serves(cuda):
    """A merged f32 session (ConvFFNs unfolded, as JAX keeps merged f32 on
    lax) answers predict_depth on the card within the serving bounds of
    its CPU answer: |d disp| mean 5e-3, max 5e-2 (chip_smoke.py)."""
    opt = Config(adapter=True, rep_size="t", height=64, width=96)
    imgs = np.random.RandomState(7).rand(2, 64, 96, 3).astype(np.float32)
    depths = []
    for device in ("cuda", "cpu"):
        sess = InferenceSession(opt, device=device, dtype="float32",
                                generator=torch.Generator().manual_seed(0))
        assert sess.model.mono_encoder.stages[0].blocks[1].folded_w_up is None
        depths.append(sess.predict_depth(imgs))

    def disp(d):
        lo, hi = 1.0 / opt.max_depth, 1.0 / opt.min_depth
        return (1.0 / d - lo) / (hi - lo)

    dd = np.abs(disp(depths[0]) - disp(depths[1]))
    assert np.isfinite(depths[0]).all()
    assert dd.mean() <= 5e-3 and dd.max() <= 5e-2, (dd.mean(), dd.max())


def test_wrappers_raise_on_cuda_float32(cuda):
    """Kernel A takes f32 now, but only with f32 weights: a mixed pair
    raises instead of falling back."""
    x = torch.zeros(1, 32, 4, 4, device=cuda).to(memory_format=torch.channels_last)
    w = torch.zeros(32, 1, 3, 3, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        lk_depthwise(x, w)
    with pytest.raises(TypeError):
        lk_depthwise(x.half(), w.half())
    # kernel B is bf16 only: f32 raises (merged f32 serving does not fold)
    C = 64
    p = FoldedFFN(torch.zeros(C, 4 * C, device=cuda), torch.zeros(4 * C, device=cuda),
                  torch.zeros(4 * C, C, device=cuda), torch.zeros(C, device=cuda))
    xf = torch.zeros(1, C, 4, 4, device=cuda).to(memory_format=torch.channels_last)
    with pytest.raises(TypeError):
        ffn_fused(xf, p)


def test_lk_dwconv_raises_on_inputs_it_does_not_take(cuda):
    """On a card kernel A launches or raises, and never falls back to the
    plain version: an x that is not 16-byte aligned, an even k or a bias
    of another type raise, and nothing is counted."""
    B, C, H, W = 1, 16, 5, 7
    base = torch.zeros(B * C * H * W + 1, device=cuda, dtype=torch.bfloat16)
    x = base.as_strided((B, C, H, W), (H * W * C, 1, W * C, C), 1)
    assert x.is_contiguous(memory_format=torch.channels_last)
    w = torch.zeros(C, 1, 3, 3, device=cuda, dtype=torch.bfloat16)
    n0 = dict(kernels.launch_counts)
    with pytest.raises(ValueError):
        lk_depthwise(x, w)
    x = torch.zeros(B, C, H, W, device=cuda, dtype=torch.bfloat16).to(
        memory_format=torch.channels_last)
    with pytest.raises(ValueError):
        lk_depthwise(x, torch.zeros(C, 1, 4, 4, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        lk_depthwise(x, w, torch.zeros(C, device=cuda))
    assert kernels.launch_counts == n0


@pytest.mark.parametrize("B,C,H,W,k", [
    *((2, *s) for s in STAGES), (2, 20, 9, 21, 7),
    *((2, 64, 12, 40, k) for k in LK_KS), *LK_RAGGED,
    *((12, *s) for s in STAGES_CS)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lk_train_matches_plain(cuda, dtype, B, C, H, W, k):
    """Kernel #2: forward (kernel A, no bias) and d/dx (kernel A on the
    flipped kernel) through the autograd Function, at the training stage
    shapes (B=2), every instantiated k and the run-time one, ragged
    shapes, and every conv shape of the stage-2 step (B=12, 192x512). bf16 as kernel A's test; f32 within 1e-4 of the peak (f32
    summation order over up to 961 taps)."""
    rng = np.random.RandomState(k)
    x = _t(rng, (B, H, W, C), 1.0, cuda, dtype).permute(0, 3, 1, 2)
    g = _t(rng, (B, H, W, C), 1.0, cuda, dtype).permute(0, 3, 1, 2)
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


@pytest.mark.parametrize("N,H,W,Ho,Wo,C", [
    pytest.param(24, 192, 640, 192, 640, 3, id="24-192-640"),  # one branch's warp
    pytest.param(24, 192, 512, 192, 512, 3, id="24-192-512"),  # stage 2's
    pytest.param(3, 7, 13, 7, 13, 3, id="3-7-13"),
    (2, 9, 30, 9, 30, 1),    # Wo % 4 == 2
    (2, 8, 21, 8, 21, 2),    # Wo % 4 == 1
    (1, 6, 20, 6, 20, 4),    # C = 4
    (2, 5, 23, 5, 23, 4),    # Wo % 4 == 3
    (2, 20, 36, 11, 38, 3),  # an output wider than the image, shorter
    (1, 9, 12, 17, 70, 3),   # an output larger than the image, Wo > 64
    (3, 7, 5, 6, 9, 1),
])
def test_warp_border_matches_plain(cuda, N, H, W, Ho, Wo, C):
    """Kernel D forward within 1e-5 (images in [0, 1]) and its coordinate
    gradient within 1e-5 of the peak, against the plain version's autograd,
    at one branch's training warp, ragged widths, C = 1-4 and outputs of
    another size than the image, with coordinates beyond the borders."""
    rng = np.random.RandomState(N)
    img = torch.from_numpy(rng.rand(N, H, W, C).astype(np.float32)).to(cuda)
    coords = torch.from_numpy(rng.uniform(-1.2, 1.2, (N, Ho, Wo, 2)).astype(
        np.float32)).to(cuda)
    g = torch.from_numpy(rng.randn(N, Ho, Wo, C).astype(np.float32)).to(cuda)
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
    (12, 128, 48, 128, 96),      # the stage-2 step, 512x192
    (12, 128, 80, 120, 96),      # the DDAD eval, 480x320
    (2, 64, 48, 160, 96),        # the legacy eval's ResNet-18 layer 1
    (6, 128, 48, 160, 96),       # a --grad_accum 2 microbatch (B=12 / 2)
    (2, 16, 13, 27, 40),         # H*W not a multiple of 8 pixels, D of 32
    (1, 256, 11, 21, 33),        # the widest C
    (2, 192, 48, 160, 96),       # rep_size l's stage 0
    (1, 256, 48, 160, 96),       # rep_size xl's stage 0
    (2, 192, 9, 23, 1),          # one bin; H, W not multiples of the tile
    (1, 40, 15, 33, 40),         # 5 vectors of bf16: idle lanes in a group
    (1, 8, 10, 14, 96),          # the narrowest C
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


@pytest.mark.parametrize("dtype,C,g", [
    (torch.bfloat16, 192, 8), (torch.bfloat16, 192, 16), (torch.float32, 192, 16),
    (torch.bfloat16, 40, 4), (torch.bfloat16, 40, 8), (torch.float32, 40, 4),
    (torch.float32, 40, 8), (torch.float32, 40, 16),
])
def test_plane_sweep_plans(cuda, dtype, C, g):
    """Every group width with the fewest 16-byte vectors a lane (1-4) that
    cover C holds kernel C's limits at a ragged shape (H and W odd, so
    the 2 x 2 pixel blocks overhang), as the shipped plan does: C=192 (24 bf16 or 48 f32 vectors)
    and C=40 (5 or 10 vectors: idle lanes in a group)."""
    B, H, W, D = 2, 13, 27, 40
    rng = np.random.RandomState(g + C)
    cur, lk, A, t, bins = _sweep_inputs(rng, B, C, H, W, D, dtype, cuda)
    nv = -(-C * cur.element_size() // (16 * g))
    y = _launch(cur, lk, A, t, bins, SweepPlan(g, nv))
    torch.cuda.synchronize()
    ref = plane_sweep_plain(cur, lk, A, t, bins)
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
