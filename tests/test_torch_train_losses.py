"""The port's photometric losses and bilinear resize against JAX on the
CPU, in f32, values and gradients: `core.losses` (reprojection loss with
and without SSIM, SSIM, automask, matching mask, smoothness) and
`ops.resize.resize_bilinear`. Split from tests/test_torch_train_kernels.py,
so that every port test file stays behind tests/test_train_step.py in
pytest-xdist's file queue.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppeadepth_tpu.core import losses as JL
from ppeadepth_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from ppeadepth_tpu_torch.core import losses as L
from ppeadepth_tpu_torch.ops.resize import resize_bilinear
from tests.test_torch_train_kernels import B, C, H, W
from tests.torch_parity import nhwc_to_torch, torch_to_nhwc
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)


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
