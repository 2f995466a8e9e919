"""Port kernels on the CPU: the plain versions of kernel A (large-kernel
depthwise conv) and kernel B (fused deploy ConvFFN) against the JAX
functions they replace, the port's FFN folding against JAX's, and the
wrappers' routing and input checks. The CUDA kernels themselves are held
against these plain versions on the card (tests/test_torch_gpu_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppeadepth_tpu.kernels import banded_conv, ffn_mxu, lk_conv
from ppeadepth_tpu.models.replknet import ConvFFN as JConvFFN
from ppeadepth_tpu_torch import kernels
from ppeadepth_tpu_torch.ckpt.convert import state_dict_from_jax
from ppeadepth_tpu_torch.kernels.ffn_fused import (
    K_TILE, TILES, FoldedFFN, ffn_fused, ffn_fused_plain,
    ffn_packed_plain, ffn_plan, fold_ffn_params, pack_ffn)
from ppeadepth_tpu_torch.kernels.lk_conv import (
    BAND_CB, BAND_MIN_K, MAX_THREADS, SMEM_PER_BLOCK, WIDE_MAX_K, BandPlan,
    LKPlan, _input_grad, band_geometry, depthwise_plain, lk_depthwise, lk_plan)
from ppeadepth_tpu_torch.models.replknet import REPLK_CONFIGS
from tests.torch_parity import nhwc_to_torch, perturb, torch_to_nhwc
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("B", [4, 8])
@pytest.mark.parametrize("k", [5, 7, 13])
def test_lk_plain_matches_jax(k, B, bias):
    """Kernel A's plain version == lax depthwise == the banded Pallas
    kernel (interpret mode, f32 build_T_t tables); atol 1e-5 as
    tests/test_banded_conv.py:33 (f32 summation order only)."""
    rng = np.random.RandomState(k * 10 + B)
    H, W, C = 6, 16, 12
    x = (rng.rand(B, H, W, C) - 0.5).astype(np.float32)
    w = (rng.randn(k, k, 1, C) * 0.1).astype(np.float32)
    b = (rng.randn(C) * 0.1).astype(np.float32)
    ref_lax = np.asarray(lk_conv._depthwise_lax(
        jnp.asarray(x), jnp.asarray(w), 1, k // 2))
    ref_banded = np.asarray(banded_conv.banded_depthwise(
        jnp.asarray(x), banded_conv.build_T_t(jnp.asarray(w), W), k,
        interpret=True))
    if bias:
        ref_lax, ref_banded = ref_lax + b, ref_banded + b
    n0 = kernels.launch_counts["lk_dwconv"]
    y = lk_depthwise(nhwc_to_torch(x),
                     torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                     torch.from_numpy(b) if bias else None)
    assert kernels.launch_counts["lk_dwconv"] == n0  # CPU: plain, no launch
    got = torch_to_nhwc(y)
    np.testing.assert_allclose(got, ref_lax, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, ref_banded, rtol=0, atol=1e-5)


C, H4, B, H, W = 16, 64, 2, 8, 24


def _jax_ffn(adpt_test, dtype, seed=0):
    """Perturbed JAX ConvFFN(merged=True) variables, an input, and the
    lax-path output."""
    rng = np.random.RandomState(seed)
    model = JConvFFN(C, H4, 0.0, adpt_test=adpt_test, g_ffn=0.7,
                     merged=True, ffn_backend="lax", dtype=dtype)
    x = rng.rand(B, H, W, C).astype(np.float32)
    variables = model.init({"params": jax.random.PRNGKey(0),
                            "droppath": jax.random.PRNGKey(1)}, x)
    variables = {k: perturb(jax.device_get(v), rng)
                 for k, v in variables.items()}
    y = np.asarray(model.apply(variables, jnp.asarray(x), False), np.float64)
    return variables, x, y


@pytest.mark.parametrize("adpt_test", [4, -1])
def test_ffn_plain_matches_lax_f32(adpt_test):
    """Kernel B's plain version on f32-folded operands == the JAX lax
    ConvFFN in f32 (erf-GELU on both sides): rel 1e-5 of the peak, the
    folding's f32 reassociation."""
    variables, x, ref = _jax_ffn(adpt_test, None)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    p = fold_ffn_params(sd, g_ffn=0.7, dtype=torch.float32)
    assert (p.a1 is None) == (adpt_test < 0)
    got = torch_to_nhwc(ffn_fused(nhwc_to_torch(x), p)).astype(np.float64)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5


@pytest.mark.parametrize("adpt_test", [4, -1])
def test_ffn_plain_matches_pallas_bf16(adpt_test):
    """Kernel B's plain version in bf16 vs the JAX Pallas kernel
    (interpret mode) on the same folded bf16 operands, at the JAX kernel
    test's bounds (tests/test_ffn_mxu.py:63-67): bf16 rounding of x, the
    weights and the hidden, plus tanh- (JAX) vs erf-GELU (port)."""
    variables, x, _ = _jax_ffn(adpt_test, jnp.bfloat16, seed=1)
    folded = ffn_mxu.fold_ffn_params(
        variables["params"], variables["batch_stats"], g_ffn=0.7)
    ref = np.asarray(ffn_mxu.ffn_block_apply(
        jnp.asarray(x, jnp.bfloat16), folded, interpret=True), np.float64)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    p = fold_ffn_params(sd, g_ffn=0.7, dtype=torch.bfloat16)
    got = torch_to_nhwc(ffn_fused(nhwc_to_torch(x).bfloat16(), p))
    diff = np.abs(got.astype(np.float64) - ref)
    scale = np.abs(ref).max()
    assert diff.max() / scale < 2.5e-2
    assert diff.mean() / scale < 3e-3


@pytest.mark.parametrize("adpt_test", [4, -1])
def test_fold_ffn_params_matches_jax(adpt_test):
    """Port folding == ffn_mxu.fold_ffn_params: f32 biases to 1e-5, bf16
    weights to 2 bf16 ulps (the f32 products round to bf16 after math
    reassociated between the two)."""
    variables, _, _ = _jax_ffn(adpt_test, jnp.bfloat16, seed=2)
    ref = ffn_mxu.fold_ffn_params(
        variables["params"], variables["batch_stats"], g_ffn=0.7)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    got = fold_ffn_params(sd, g_ffn=0.7, dtype=torch.bfloat16)
    names = FoldedFFN._fields if adpt_test >= 0 else FoldedFFN._fields[:4]
    for name, r in zip(names, ref):
        g = getattr(got, name)
        r = np.asarray(r, np.float32).reshape(g.shape)
        if name.startswith(("b", "ab")):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-6)
        else:
            assert g.dtype == torch.bfloat16
            np.testing.assert_allclose(g.float().numpy(), r, rtol=8e-3,
                                       atol=1e-6)
    if adpt_test < 0:
        assert all(getattr(got, n) is None for n in FoldedFFN._fields[4:])


@pytest.mark.parametrize("C", [16, 64, 1536])
@pytest.mark.parametrize("adpt_test", [4, -1])
def test_pack_ffn_plain_matches_unpacked(adpt_test, C):
    """The packed operands (adapter folded into the main products, the
    hidden zero-padded to the K tile, weights K-major) compute what the
    folded ones do: in f32 within 1e-6 (summation order only)."""
    rng = np.random.RandomState(C)
    H4, CA = 4 * C, C // 4

    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))

    ada = ((r(C, CA, scale=C ** -0.5), r(CA, scale=0.1),
            r(CA, C, scale=CA ** -0.5), r(C, scale=0.1))
           if adpt_test >= 0 else ())
    p = FoldedFFN(r(C, H4, scale=C ** -0.5), r(H4, scale=0.1),
                  r(H4, C, scale=H4 ** -0.5), r(C, scale=0.1), *ada)
    pk = pack_ffn(p)
    Hp = -(-(H4 + (CA if ada else 0)) // K_TILE) * K_TILE
    assert pk.w_up.shape == (Hp, C) and pk.w_down.shape == (C, Hp)
    assert all(t.is_contiguous() for t in pk)
    x = torch.from_numpy(rng.rand(24, C).astype(np.float32))
    torch.testing.assert_close(ffn_packed_plain(x, pk), ffn_fused_plain(x, p),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("M,H4", [
    (61440, 512), (15360, 1024), (3840, 2048), (960, 4096), (100, 1024),
    (1, 64), (960, 16)])
def test_ffn_plan_covers_every_tile(M, H4):
    """Kernel B's tile plan for both products of a ConvFFN of hidden width
    H4 (C = H4/4, at least 64; packed hidden 4C + C/4 padded): the grid
    (N / BN, ceil(M / BM)) covers every output element exactly once, each
    block walks every K tile once, and a launch has at least 132 blocks
    unless no tile that fits gives more."""
    C = max(K_TILE, H4 // 4)
    Hp = -(-(4 * C + C // 4) // K_TILE) * K_TILE
    for N, K, tile in ((Hp, C, ffn_plan(M, C, Hp, 132)[0]),
                       (C, Hp, ffn_plan(M, C, Hp, 132)[1])):
        bm, bn = TILES[tile]
        rows = np.zeros(M, np.int64)
        cols = np.zeros(N, np.int64)
        for m0 in range(0, -(-M // bm) * bm, bm):
            rows[m0:m0 + bm] += 1
        for n0 in range(0, N // bn * bn, bn):
            cols[n0:n0 + bn] += 1
        assert (rows == 1).all() and (cols == 1).all()
        assert K % K_TILE == 0
        blocks = [-(-M // b) * (N // n) for b, n in TILES if N % n == 0]
        assert -(-M // bm) * (N // bn) >= min(132, max(blocks))


def _lk_main_shapes():
    """(B, H, W, C, k) of kernel A on the main paths at 640x192, B=8 and
    12, for rep_size b, l and xl (dw_ratio widens xl to C=3072): each
    stage's large kernel, its small kernel and the stem's stride-1 3x3."""
    shapes = set()
    for cfg in REPLK_CONFIGS.values():
        for i, (C, k) in enumerate(zip(cfg["channels"], cfg["large_kernel_sizes"])):
            C = int(C * cfg["dw_ratio"])
            for B in (8, 12):
                for kk in {k, cfg["small_kernel"] or k}:
                    shapes.add((B, 48 >> i, 160 >> i, C, kk))
                shapes.add((B, 96, 320, cfg["channels"][0], 3))
    return sorted(shapes)


LK_MAIN = _lk_main_shapes()
LK_RAGGED = [(20, 9, 21, 7), (7, 9, 21, 5), (20, 9, 21, 27), (13, 11, 23, 9),
             (3, 1, 1, 31), (1000, 5, 3, 13)]


def _band_plan_coverage(B, H, W, C, k, p):
    """Walk the banded instance's blocks, warp tasks and accumulator
    elements as csrc/lk_dwconv.cu `lk_dwconv_kernel_banded` maps them
    (channel group = blockIdx.x; images and row tile = blockIdx.y; task =
    row group of NR rows of NI images x column segment; element = tile t,
    column g (+8), group row 2q (+1)) and count how often each (image,
    row, column) and each channel is written; check the shared-memory
    layout the kernel indexes."""
    half = k // 2
    off, j = band_geometry(k)
    assert (p.off, p.j, p.ni * p.nr) == (off, j, 8) and p.th % p.nr == 0
    seen = np.zeros((B, H, W), int)
    n = np.arange(8)
    for gy in range(p.grid[1]):
        b0, h0 = gy // p.tiles_h * p.ni, gy % p.tiles_h * p.th
        y_end = min(H, h0 + p.th)
        for task in range(p.th // p.nr * p.segs):
            rg, seg = divmod(task, p.segs)
            y0 = h0 + rg * p.nr
            ylast = min(y0 + p.nr, y_end) - 1
            if ylast < y0:
                continue
            ox = seg * p.nt * 16 + np.arange(p.nt * 16)
            oy, bb = y0 + n % p.nr, b0 + n // p.nr
            ok_x, ok_n = ox < W, (oy <= ylast) & (bb < B)
            np.add.at(seen, (bb[ok_n][:, None], oy[ok_n][:, None], ox[ok_x][None]), 1)
        # the tile's halo rows fit each image's staged rows
        assert min(H - 1, h0 + p.th - 1 + half) - max(0, h0 - half) < p.rows
    assert (seen == 1).all()
    chans = np.zeros(C, int)
    for g in range(p.grid[0]):
        c = g * BAND_CB + np.arange(BAND_CB)
        np.add.at(chans, c[c < C], 1)
    assert (chans == 1).all()
    assert p.pitch % 16 == 8 and p.pitch >= (p.segs * p.nt + j - 1) * 16
    assert p.img_stride >= p.rows * p.pitch and p.img_stride % 8 == 0
    # the eight rows an ldmatrix reads fall in eight 16-byte bank quarters
    offs = (n // p.nr) * p.img_stride + (n % p.nr) * p.pitch
    assert len({o // 8 % 8 for o in offs}) == 8
    assert p.chan_stride == p.ni * p.img_stride + p.pitch
    tables = -(-((BAND_CB * k - 1) * p.tstride + p.tlen) // 4) * 4
    assert p.smem == (BAND_CB * p.chan_stride * 2 + tables * 4
                      + BAND_CB * k * k * 2) <= SMEM_PER_BLOCK
    assert p.grid[1] <= 65535 and 1 <= p.warps <= 8 and p.blocks_per_sm >= 1
    return p


def _lk_plan_coverage(B, H, W, C, k, dtype):
    """Walk kernel A's blocks and threads as csrc/lk_dwconv.cu maps them
    (channel group = blockIdx.y; block blockIdx.x takes tiles blockIdx.x,
    + gridDim.x, ... of the B * tiles_h * tiles_w (image, tile) pairs;
    thread = channel pair, row, strip) and count how often each output
    (image, row, column, channel) is written; per image the map is a
    product of rows, columns and channels. The banded instance (bf16,
    k >= 13) by `_band_plan_coverage`."""
    p = lk_plan(B, H, W, C, k, dtype)
    banded = dtype == torch.bfloat16 and k >= BAND_MIN_K
    assert isinstance(p, BandPlan if banded else LKPlan)
    if banded:
        return _band_plan_coverage(B, H, W, C, k, p)
    lanes = p.cb // 2
    tw = p.twt * p.tws
    n_tiles = B * p.tiles_h * p.tiles_w
    assert p.grid[1] == p.groups and 1 <= p.grid[0] <= n_tiles
    seen = np.zeros(n_tiles, int)
    for bx in range(p.grid[0]):
        seen[bx::p.grid[0]] += 1
    assert (seen == 1).all()  # each (image, tile) by one block, once
    assert p.threads == lanes * p.th * p.tws <= MAX_THREADS[k <= WIDE_MAX_K]
    tids = np.arange(p.threads)
    lane, r, s = tids % lanes, tids // lanes % p.th, tids // (lanes * p.th)
    assert len({*zip(lane, r, s)}) == p.threads
    assert (s < p.tws).all()
    rows, cols, chans = np.zeros(H, int), np.zeros(W, int), np.zeros(C, int)
    for t in range(p.tiles_h):
        oh = t * p.th + np.arange(p.th)
        np.add.at(rows, oh[oh < H], 1)
        # the halo rows inside the image fit the allocated rows
        assert min(H - 1, t * p.th + p.th - 1 + k // 2) - max(0, t * p.th - k // 2) < p.rows
    for t in range(p.tiles_w):
        ow = t * tw + np.arange(tw)
        np.add.at(cols, ow[ow < W], 1)
    for g in range(p.groups):
        c = g * p.cb + 2 * np.arange(lanes)
        for cc in (c, c + 1):
            np.add.at(chans, cc[cc < C], 1)
    assert (rows == 1).all() and (cols == 1).all() and (chans == 1).all()
    esize = 2 if dtype == torch.bfloat16 else 4
    wide = k <= WIDE_MAX_K
    assert p.cb == (128 // esize if wide else 8)  # narrow: f32 in shared memory
    sesize = esize if wide else 4
    assert p.pitch >= tw + k - 1 and (wide or p.pitch % 4 == 1)
    assert p.rows == min(p.th + k - 1, H)
    assert p.nbuf in ((2, 3) if wide else (1,))
    assert p.smem == (k * k + p.nbuf * p.rows * p.pitch) * p.cb * sesize <= SMEM_PER_BLOCK
    assert p.groups <= 65535
    return p


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,W,C,k", LK_MAIN, ids=lambda v: str(v))
def test_lk_plan_covers_every_output(B, H, W, C, k, dtype):
    """Kernel A's plan at the main paths' shapes (rep_size b, l, xl): every
    output (b, h, w, c) exactly once, shared memory within 227 KB, and two
    or more resident blocks per SM (the CUDA-core instances)."""
    p = _lk_plan_coverage(B, H, W, C, k, dtype)
    if isinstance(p, LKPlan):
        assert p.blocks_per_sm >= 2


# every large-kernel conv of the serving and training paths and the evals:
# the four stages at 640x192 (KITTI), 512x192 (CityScapes) and 320x480
# (DDAD, 15 wide at stage 4), the serving batch, the training batch and its
# half, 3 and 1; with the stage's small kernel (k=5)
_LK_FAMILY = sorted({(B, h // 4 >> i, w // 4 >> i, C, kk)
                     for h, w in ((192, 640), (192, 512), (320, 480))
                     for i, (C, k) in enumerate(zip(REPLK_CONFIGS["b"]["channels"],
                                                    REPLK_CONFIGS["b"]["large_kernel_sizes"]))
                     for B in (32, 12, 6, 3, 1) for kk in (k, 5)})


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,W,C,k", _LK_FAMILY, ids=lambda v: str(v))
def test_lk_plan_family(B, H, W, C, k, dtype):
    """The instance family rests on dtype and k alone: every bf16 k >= 13
    shape takes the banded (tensor-core) instance, every f32 shape and
    every k <= 11 the CUDA-core ones; each plan covers every output once."""
    p = _lk_plan_coverage(B, H, W, C, k, dtype)
    assert isinstance(p, BandPlan) == (dtype == torch.bfloat16 and k >= 13)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B", [1, 12])
@pytest.mark.parametrize("C,H,W,k", LK_RAGGED)
def test_lk_plan_covers_ragged_shapes(C, H, W, k, B, dtype):
    """The plan at ragged shapes (C not a multiple of 8 or odd, H and W no
    multiple of the tile, k beyond H and W): every output exactly once,
    shared memory within 227 KB."""
    _lk_plan_coverage(B, H, W, C, k, dtype)


@pytest.mark.parametrize("k", [3, 9, 31])
def test_input_grad_cpu_is_plain_on_flipped_kernel(k):
    """d/dx on the CPU: the plain conv of the gradient with the kernel
    flipped in both spatial axes (kernel A reads it flipped in place)."""
    g = torch.Generator().manual_seed(k)
    dy = torch.randn(2, 20, 9, 21, generator=g)
    w = torch.randn(20, 1, k, k, generator=g)
    before = dict(kernels.launch_counts)
    dx = _input_grad(dy, w)
    torch.testing.assert_close(dx, depthwise_plain(dy, w.flip(-1, -2)),
                               rtol=0, atol=0)
    assert kernels.launch_counts == before


def _ffn_operands(dtype=torch.float32, c=16, adapter=True):
    g = torch.Generator().manual_seed(0)

    def r(*shape, dt=dtype):
        return torch.randn(*shape, generator=g).to(dt)

    f32 = torch.float32
    ada = (r(c, 4), r(4, dt=f32), r(4, c), r(c, dt=f32)) if adapter else ()
    return FoldedFFN(r(c, 4 * c), r(4 * c, dt=f32), r(4 * c, c), r(c, dt=f32),
                     *ada)


def test_wrappers_route_cpu_to_plain():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 6, 5, 16, generator=g).permute(0, 3, 1, 2)
    w = torch.randn(16, 1, 5, 5, generator=g)
    before = dict(kernels.launch_counts)
    torch.testing.assert_close(lk_depthwise(x, w), depthwise_plain(x, w),
                               rtol=0, atol=0)
    p = _ffn_operands()
    y = ffn_fused(x, p)
    ref = ffn_fused_plain(x.permute(0, 2, 3, 1).reshape(-1, 16), p)
    torch.testing.assert_close(y.permute(0, 2, 3, 1).reshape(-1, 16), ref,
                               rtol=0, atol=0)
    assert y.is_contiguous(memory_format=torch.channels_last)
    pk = pack_ffn(p)
    y = ffn_fused(x, pk)
    ref = ffn_packed_plain(x.permute(0, 2, 3, 1).reshape(-1, 16), pk)
    torch.testing.assert_close(y.permute(0, 2, 3, 1).reshape(-1, 16), ref,
                               rtol=0, atol=0)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert kernels.launch_counts == before


def _x(dtype=torch.float32, layout="cl"):
    x = torch.zeros(2, 16, 6, 5, dtype=dtype)
    return x.contiguous(memory_format=torch.channels_last) if layout == "cl" else x


_W = torch.zeros(16, 1, 5, 5)


@pytest.mark.parametrize("call,exc", [
    (lambda: lk_depthwise(_x(torch.float64), _W.double()), TypeError),
    (lambda: lk_depthwise(_x(torch.bfloat16), _W), TypeError),
    (lambda: lk_depthwise(_x(), torch.zeros(16, 1, 4, 4)), ValueError),
    (lambda: lk_depthwise(_x(), torch.zeros(16, 1, 33, 33)), ValueError),
    (lambda: lk_depthwise(_x(), torch.zeros(8, 1, 5, 5)), ValueError),
    (lambda: lk_depthwise(_x(), _W, torch.zeros(8)), ValueError),
    (lambda: lk_depthwise(_x(layout="nchw"), _W), ValueError),
    (lambda: ffn_fused(_x(torch.float64), _ffn_operands()), TypeError),
    (lambda: ffn_fused(_x(torch.bfloat16), _ffn_operands()), TypeError),
    (lambda: ffn_fused(_x(), _ffn_operands(c=32)), ValueError),
    (lambda: ffn_fused(_x(), _ffn_operands()._replace(b1=torch.zeros(64).bfloat16())),
     TypeError),
    (lambda: ffn_fused(_x(), _ffn_operands()._replace(a2=None)), ValueError),
    (lambda: ffn_fused(_x(layout="nchw"), _ffn_operands()), ValueError),
    (lambda: ffn_fused(_x(torch.bfloat16), pack_ffn(_ffn_operands())),
     TypeError),
    (lambda: ffn_fused(_x(), pack_ffn(_ffn_operands(c=32))), ValueError),
])
def test_wrappers_reject_bad_inputs(call, exc):
    with pytest.raises(exc):
        call()
