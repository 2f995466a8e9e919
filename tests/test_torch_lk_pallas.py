"""TPU kernel #3 (`ppeadepth_tpu/kernels/lk_conv_pallas.py:70
depthwise_conv2d_pallas`) and its port: `kernels.lk_conv.lk_depthwise`
(kernel A; its plain version on the CPU) against the Pallas kernel run
in interpret mode, as tests/test_lk_conv.py runs it; and the port's eval
forward under `--lk_backend pallas` (the stem's stride-1 3x3 conv on
kernel A) against the same forward under "lax"."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ppeadepth_tpu.kernels import lk_conv_pallas as P
from ppeadepth_tpu_torch.eval.evaluator import make_eval_step
from ppeadepth_tpu_torch.kernels.lk_conv import lk_depthwise
from ppeadepth_tpu_torch.models import RepDepth, init_weights
from ppeadepth_tpu_torch.options import Config
from tests.torch_parity import nhwc_to_torch, torch_to_nhwc
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("k", [3, 5, 13, 31])
def test_lk_depthwise_matches_pallas(k, B):
    """f32, atol 1e-5. H=13 is no multiple of the Pallas kernel's 8-row
    tile, so its padded-H path runs; W=20 < k=31 clips every tap row."""
    rng = np.random.RandomState(10 * k + B)
    H, W, C = 13, 20, 8
    x = rng.rand(B, H, W, C).astype(np.float32)
    w = (rng.randn(k, k, 1, C) * 0.1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(P.depthwise_conv2d_pallas(
            jnp.asarray(x), jnp.asarray(w), k // 2))
    got = lk_depthwise(nhwc_to_torch(x),
                       torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
    np.testing.assert_allclose(torch_to_nhwc(got), ref, rtol=0, atol=1e-5)


def _batch(opt, B, rng):
    """An eval batch (the loader's keys the eval step reads) as tensors."""
    batch = {}
    for f in (0, -1):
        batch[("color", f, 0)] = torch.from_numpy(
            rng.rand(B, opt.height, opt.width, 3).astype(np.float32))
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1] = 0.58 * opt.width / 4, 1.92 * opt.height / 4
    K[0, 2], K[1, 2] = 0.5 * opt.width / 4, 0.5 * opt.height / 4
    batch[("K", 2)] = torch.from_numpy(np.stack([K] * B))
    batch[("inv_K", 2)] = torch.from_numpy(np.stack([np.linalg.pinv(K)] * B))
    return batch


def test_eval_forward_pallas_equals_lax():
    """Rep "t", 64x96, B=2, f32, post-process and teacher: the same weights
    give the same disparities (atol 1e-6) under both backends, and only
    "pallas" routes the stem's 3x3 conv through kernel A's wrapper."""
    opt = Config(adapter=True, rep_size="t", height=64, width=96,
                 post_process=True)
    models = {}
    for backend in ("lax", "pallas"):
        m = RepDepth(opt.replace(lk_backend=backend))
        if not models:
            init_weights(m, torch.Generator().manual_seed(0))
        else:
            m.load_state_dict(models["lax"].state_dict(), strict=True)
        models[backend] = m.eval()
    for enc in ("mono_encoder", "encoder"):
        stems = {b: getattr(m, enc) for b, m in models.items()}
        stems = {b: (e.replk if enc == "encoder" else e).stem[1].conv
                 for b, e in stems.items()}
        assert stems["pallas"].kernel_a and not stems["lax"].kernel_a
    batch = _batch(opt, 2, np.random.RandomState(0))
    out = {b: make_eval_step(m, opt, True)(batch, 0.1, 10.0)
           for b, m in models.items()}
    for got, ref in zip(out["pallas"], out["lax"]):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-6)
    assert out["lax"][0].shape == (2, 2, 64, 96)
