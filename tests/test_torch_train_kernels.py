"""Kernel D's plain version (`kernels.warp.warp_border` on CPU tensors)
against JAX on the CPU, in f32: against ops/sampling.grid_sample(...,
"border") and its autodiff coordinate gradient, and against the Pallas
kernel `warp_mxu.grid_sample_border_mxu` in interpret mode in its exact f32
mode and its custom VJP, at fractional, integer and out-of-range
coordinates; its input checks; and the zeros-padding `grid_sample`.
Kernel #2 and the geometry are in tests/test_torch_train_geometry.py, the
losses in tests/test_torch_train_losses.py (files of at most 10 tests keep
every port test file behind tests/test_train_step.py in pytest-xdist's
file queue).

The CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_gpu_kernels.py, chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppeadepth_tpu.kernels import warp_mxu
from ppeadepth_tpu.ops.sampling import grid_sample as jax_grid_sample
from ppeadepth_tpu_torch import kernels
from ppeadepth_tpu_torch.kernels.warp import warp_border
from ppeadepth_tpu_torch.ops.sampling import grid_sample
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
