"""The port's training kernels' plain versions, geometry and losses against
JAX on the CPU, in f32:

  * kernel D's plain version (`kernels.warp.warp_border` on CPU tensors)
    against ops/sampling.grid_sample(..., "border") and its autodiff
    coordinate gradient, and against the Pallas kernel
    `warp_mxu.grid_sample_border_mxu` in interpret mode in its exact f32
    mode and its custom VJP, at fractional, integer and out-of-range
    coordinates;
  * kernel #2 (`kernels.lk_conv.lk_depthwise_train`: forward, d/dx on the
    flipped kernel, d/dw when the weight requires grad) against
    `banded_conv.banded_depthwise_train` in interpret mode;
  * `core.geometry` reprojection and `core.losses` against their JAX
    counterparts, values and gradients.

The CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_gpu_kernels.py, chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppeadepth_tpu.core import geometry as jgeo
from ppeadepth_tpu.core import losses as JL
from ppeadepth_tpu.kernels import banded_conv, warp_mxu
from ppeadepth_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from ppeadepth_tpu.ops.sampling import grid_sample as jax_grid_sample
from ppeadepth_tpu_torch import kernels
from ppeadepth_tpu_torch.core import geometry as G
from ppeadepth_tpu_torch.core import losses as L
from ppeadepth_tpu_torch.kernels.lk_conv import lk_depthwise_train
from ppeadepth_tpu_torch.kernels.warp import warp_border
from ppeadepth_tpu_torch.ops.resize import resize_bilinear
from ppeadepth_tpu_torch.ops.sampling import grid_sample
from tests.test_torch_student import T_GIVEN, intrinsics
from tests.torch_parity import nhwc_to_torch, torch_to_nhwc
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

# W - 1 and H - 1 powers of two: an integer pixel position survives the
# normalise -> unnormalise round trip exactly
B, H, W, C = 2, 9, 17, 3


def _pixels(case, rng):
    """Pixel positions [B, H, W, 2] of a coordinate case. None of them lies
    on the clamp borders 0 and W - 1 themselves, where jnp.clip splits the
    gradient in half and torch.clamp and the kernels pass it whole."""
    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    base = np.stack([gx, gy], -1)[None].repeat(B, 0).astype(np.float64)
    if case == "fractional":
        px = base + rng.uniform(-3, 3, base.shape)
        lim = np.array([W - 1, H - 1])
        return np.clip(px, 0.05, lim - 0.05)
    if case == "integer":
        shift = rng.randint(-3, 4, base.shape)
        return np.clip(base + shift, 1, np.array([W - 2, H - 2]))
    assert case == "out_of_range"
    px = base + rng.uniform(-3, 3, base.shape)
    px[:, :3] -= 6.0  # above the top border
    px[:, :, -4:, 0] += 9.0  # right of the right border
    px = np.where(np.abs(px - np.array([W - 1, H - 1])) < 0.05, px + 0.1, px)
    return np.where(np.abs(px) < 0.05, px - 0.1, px)


def _coords(px):
    """Pixel positions -> normalised align_corners coordinates (exact for
    integer positions: the scales are powers of two)."""
    scale = np.array([W - 1, H - 1], np.float64)
    return (px / scale * 2.0 - 1.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_warps():
    """Jitted (value, coordinate VJP) of the lax warp and of the Pallas
    kernel in interpret mode, exact f32 mode: compiled once per process."""
    def lax_fn(img, c):
        return jax_grid_sample(img, c, "border")

    def pallas_fn(img, c):
        return warp_mxu.grid_sample_border_mxu(img, c, True, "highest", "float32")

    def with_vjp(fn):
        def run(img, c, g):
            out, vjp = jax.vjp(lambda cc: fn(img, cc), c)
            return out, vjp(g)[0]
        return jax.jit(run)

    return with_vjp(lax_fn), with_vjp(pallas_fn)


@pytest.mark.parametrize("case", ["fractional", "integer", "out_of_range"])
def test_warp_plain_matches_jax_and_pallas(case):
    """Forward atol 1e-6 (f32 blend of values in [0, 1], the same order of
    operations); coordinate gradient atol 2e-5 (its entries reach ~10:
    (W - 1) / 2 = 8 times a channel sum, rounded in another order)."""
    rng = np.random.RandomState({"fractional": 0, "integer": 1,
                                 "out_of_range": 2}[case])
    img = rng.rand(B, H, W, C).astype(np.float32)
    px = _pixels(case, rng)
    coords = _coords(px)
    cot = rng.randn(B, H, W, C).astype(np.float32)
    lax_vjp, pallas_vjp = _jax_warps()

    c = torch.from_numpy(coords).requires_grad_(True)
    n0 = dict(kernels.launch_counts)
    out = warp_border(torch.from_numpy(img), c)
    out.backward(torch.from_numpy(cot))
    assert kernels.launch_counts == n0  # CPU: the plain version, no launch
    for name, fn in (("lax", lax_vjp), ("pallas", pallas_vjp)):
        ref, dref = (np.asarray(a) for a in fn(jnp.asarray(img),
                                               jnp.asarray(coords),
                                               jnp.asarray(cot)))
        np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(c.grad.numpy(), dref, rtol=0, atol=2e-5,
                                   err_msg=name)
    if case == "out_of_range":
        # clamped on both axes: no gradient at all
        both = ((px < 0) | (px > np.array([W - 1, H - 1]))).all(-1)
        assert both.any() and (c.grad.numpy()[both] == 0).all()
    else:
        assert np.abs(c.grad.numpy()).max() > 0.1


def test_warp_border_image_gets_no_gradient():
    rng = np.random.RandomState(3)
    img = torch.from_numpy(rng.rand(B, H, W, C).astype(np.float32)).requires_grad_()
    c = torch.from_numpy(_coords(_pixels("fractional", rng))).requires_grad_()
    warp_border(img, c).sum().backward()
    assert img.grad is None and c.grad is not None


@pytest.mark.parametrize("kw,err", [
    (dict(img=(B, H, W, 5)), ValueError),          # more than 4 channels
    (dict(coords=(B, H, W, 3)), ValueError),       # not (x, y)
    (dict(dtype=torch.float64), TypeError),
    (dict(strided=True), ValueError),              # not contiguous
])
def test_warp_border_rejects_bad_inputs(kw, err):
    img = torch.zeros(kw.get("img", (B, H, W, C)), dtype=kw.get("dtype", torch.float32))
    coords = torch.zeros(kw.get("coords", (B, H, W, 2)), dtype=kw.get("dtype", torch.float32))
    if kw.get("strided"):
        img = torch.zeros(B, H, 2 * W, C)[:, :, ::2]
    with pytest.raises(err):
        warp_border(img, coords)


def test_grid_sample_zeros_matches_jax():
    """The zeros-padding mode, out-of-range samples included (atol 1e-6)."""
    rng = np.random.RandomState(4)
    img = rng.rand(B, H, W, C).astype(np.float32)
    coords = _coords(_pixels("out_of_range", rng))
    ref = np.asarray(jax_grid_sample(jnp.asarray(img), jnp.asarray(coords), "zeros"))
    got = grid_sample(torch.from_numpy(img), torch.from_numpy(coords), "zeros")
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_banded_train(k):
    """Jitted (forward, d/dx, d/dw) of banded_depthwise_train in interpret
    mode with f32 tables."""
    def run(x, w, g):
        y, vjp = jax.vjp(lambda xx, ww: banded_conv.banded_depthwise_train(
            xx, ww, k, True, jnp.float32), x, w)
        return (y,) + vjp(g)
    return jax.jit(run)


@pytest.mark.parametrize("want_dw", [False, True], ids=["frozen_w", "trained_w"])
@pytest.mark.parametrize("k", [5, 7])
def test_lk_train_matches_banded_pallas(k, want_dw):
    """Forward, d/dx and d/dw: atol 1e-5 as tests/test_banded_conv.py's f32
    table checks of the forward (summation order only); d/dw sums over
    B*H*W products, atol 1e-4."""
    rng = np.random.RandomState(k)
    Bx, Hx, Wx, Cx = 4, 6, 16, 8
    x = (rng.rand(Bx, Hx, Wx, Cx) - 0.5).astype(np.float32)
    w = (rng.randn(k, k, 1, Cx) * 0.1).astype(np.float32)
    g = rng.randn(Bx, Hx, Wx, Cx).astype(np.float32)
    y_ref, dx_ref, dw_ref = (np.asarray(a) for a in _jax_banded_train(k)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(g)))

    xt = nhwc_to_torch(x).requires_grad_(True)
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_(want_dw)
    n0 = dict(kernels.launch_counts)
    y = lk_depthwise_train(xt, wt)
    y.backward(nhwc_to_torch(g))
    assert kernels.launch_counts == n0
    np.testing.assert_allclose(torch_to_nhwc(y), y_ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(torch_to_nhwc(xt.grad), dx_ref, rtol=0, atol=1e-5)
    if want_dw:
        np.testing.assert_allclose(wt.grad.numpy().transpose(2, 3, 1, 0),
                                   dw_ref, rtol=0, atol=1e-4)
    else:
        assert wt.grad is None


def _depth(rng, h, w):
    return (rng.rand(B, h, w, 1) * 20 + 1).astype(np.float32)


def test_backproject_and_project_match_jax():
    """atol 1e-5 on coordinates in [-1, 1]-ish and points of depth <= 21
    (f32 products of 3x3 and 4x4 matrices)."""
    rng = np.random.RandomState(5)
    K, invK = intrinsics(H, W)
    depth = _depth(rng, H, W)
    pts_ref = np.asarray(jgeo.backproject_depth(jnp.asarray(depth), jnp.asarray(invK)))
    pts = G.backproject_depth(torch.from_numpy(depth), torch.from_numpy(invK))
    np.testing.assert_allclose(pts.numpy(), pts_ref, rtol=1e-6, atol=1e-5)
    ref = np.asarray(jgeo.project_3d(jnp.asarray(pts_ref), jnp.asarray(K),
                                     jnp.asarray(T_GIVEN), H, W))
    got = G.project_3d(torch.from_numpy(pts_ref), torch.from_numpy(K),
                       torch.from_numpy(T_GIVEN), H, W)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_reproject_coords_matches_jax_with_gradients():
    """Coordinates and the gradients of a weighted sum with respect to
    depth and pose: rtol 1e-4 (the chain's f32 rounding, relative to
    gradients that scale with the intrinsics)."""
    rng = np.random.RandomState(6)
    K, invK = intrinsics(H, W)
    depth = _depth(rng, H, W)
    wgt = rng.randn(B, H, W, 2).astype(np.float32)

    def f(d, T):
        c = jgeo.reproject_coords(d, jnp.asarray(invK), jnp.asarray(K), T)
        return jnp.sum(c * wgt), c

    (_, ref), (gd_ref, gT_ref) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(depth), jnp.asarray(T_GIVEN))
    d = torch.from_numpy(depth).requires_grad_()
    T = torch.from_numpy(T_GIVEN).requires_grad_()
    c = G.reproject_coords(d, torch.from_numpy(invK), torch.from_numpy(K), T)
    (c * torch.from_numpy(wgt)).sum().backward()
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(gd_ref), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(T.grad.numpy(), np.asarray(gT_ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("no_ssim", [False, True])
def test_reprojection_loss_matches_jax_with_gradient(no_ssim):
    """Per-pixel loss and its gradient with respect to the prediction
    (atol 1e-6 / 1e-6: f32 pooling sums in another order)."""
    rng = np.random.RandomState(7)
    pred = rng.rand(B, H, W, C).astype(np.float32)
    target = rng.rand(B, H, W, C).astype(np.float32)
    wgt = rng.rand(B, H, W, 1).astype(np.float32)

    def f(p):
        r = JL.reprojection_loss(p, jnp.asarray(target), no_ssim)
        return jnp.sum(r * wgt), r

    (_, ref), gref = jax.value_and_grad(f, has_aux=True)(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    r = L.reprojection_loss(p, torch.from_numpy(target), no_ssim)
    (r * torch.from_numpy(wgt)).sum().backward()
    assert r.shape == (B, H, W, 1)
    np.testing.assert_allclose(r.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gref), rtol=0, atol=1e-6)


def test_ssim_automask_and_matching_mask_match_jax():
    rng = np.random.RandomState(8)
    x = rng.rand(B, H, W, C).astype(np.float32)
    y = rng.rand(B, H, W, C).astype(np.float32)
    np.testing.assert_allclose(
        L.ssim(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(JL.ssim(jnp.asarray(x), jnp.asarray(y))), rtol=0, atol=1e-6)
    a, b = rng.rand(2, B, H, W, 1).astype(np.float32)
    b[0, 0, :3] = a[0, 0, :3]  # ties: strict '<' keeps them out
    np.testing.assert_array_equal(
        L.automask(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(JL.automask(jnp.asarray(a), jnp.asarray(b))))
    mono = (rng.rand(B, H, W, 1) * 10 + 0.5).astype(np.float32)
    low = (1.0 / (mono[..., 0] * rng.uniform(0.3, 3.0, (B, H, W)))).astype(np.float32)
    got = L.matching_mask(torch.from_numpy(mono), torch.from_numpy(low)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JL.matching_mask(jnp.asarray(mono), jnp.asarray(low))))
    assert 0.1 < got.mean() < 0.9


def test_smooth_losses_match_jax_with_gradient():
    """smooth_loss and normalized_smooth_loss and the gradient of the
    latter with respect to the disparity (rtol 1e-5: f32 means)."""
    rng = np.random.RandomState(9)
    disp = rng.rand(B, H, W, 1).astype(np.float32) + 0.1
    img = rng.rand(B, H, W, C).astype(np.float32)
    np.testing.assert_allclose(
        float(L.smooth_loss(torch.from_numpy(disp), torch.from_numpy(img))),
        float(JL.smooth_loss(jnp.asarray(disp), jnp.asarray(img))), rtol=1e-5)
    ref, gref = jax.value_and_grad(
        lambda d: JL.normalized_smooth_loss(d, jnp.asarray(img)))(jnp.asarray(disp))
    d = torch.from_numpy(disp).requires_grad_()
    got = L.normalized_smooth_loss(d, torch.from_numpy(img))
    got.backward()
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(gref), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("hw", [(18, 34), (36, 68), (9, 17)])
def test_resize_bilinear_matches_jax(hw):
    """Half-pixel bilinear upscale (atol 1e-6); the same size is the
    identity."""
    x = np.random.RandomState(10).rand(B, H, W, 1).astype(np.float32)
    ref = np.asarray(jax_resize_bilinear(jnp.asarray(x), *hw))
    got = torch_to_nhwc(resize_bilinear(nhwc_to_torch(x), *hw))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
