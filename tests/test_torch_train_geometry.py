"""The port's kernel #2 plain version and reprojection geometry against
JAX on the CPU, in f32:

  * kernel #2 (`kernels.lk_conv.lk_depthwise_train`: forward, d/dx on the
    flipped kernel, d/dw when the weight requires grad) against
    `banded_conv.banded_depthwise_train` in interpret mode;
  * `core.geometry` backprojection, projection and reprojection against
    their JAX counterparts, values and gradients.

Split from tests/test_torch_train_kernels.py (kernel D's plain version)
and beside tests/test_torch_train_losses.py, so that every port test file
stays behind tests/test_train_step.py in pytest-xdist's file queue. The
CUDA kernels themselves are held against these plain versions on the card
(tests/test_torch_gpu_kernels.py, chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppeadepth_tpu.core import geometry as jgeo
from ppeadepth_tpu.kernels import banded_conv
from ppeadepth_tpu_torch import kernels
from ppeadepth_tpu_torch.core import geometry as G
from ppeadepth_tpu_torch.kernels.lk_conv import lk_depthwise_train
from tests.test_torch_student import T_GIVEN, intrinsics
from tests.test_torch_train_kernels import B, H, W
from tests.torch_parity import nhwc_to_torch, torch_to_nhwc
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)


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
