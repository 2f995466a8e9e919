"""Port modules against JAX in f32 at 64x96: RepLKNet("t") with adapters
in training form, merged form, and merged form with ConvFFNs folded into
kernel-B operands (the deploy path, here through the plain versions),
DepthDecoderV2, and the nearest resizes. atol 2e-4 as tests/test_banded_conv.py:209 (f32 summation
order through the tiny net)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppeadepth_tpu.ckpt.deploy import structural_reparam as jax_reparam
from ppeadepth_tpu.models.depth_decoder import DepthDecoderV2 as JDecoder
from ppeadepth_tpu.models.replknet import RepLKNet as JRepLKNet
from ppeadepth_tpu.ops.resize import resize_nearest as jax_resize
from ppeadepth_tpu.ops.resize import upsample2x_nearest as jax_up2
from ppeadepth_tpu_torch.ckpt.convert import state_dict_from_jax
from ppeadepth_tpu_torch.models.depth_decoder import DepthDecoderV2
from ppeadepth_tpu_torch.models.replknet import RepLKNet, num_ch_enc
from ppeadepth_tpu_torch.ops.resize import resize_nearest, upsample2x_nearest
from tests.torch_parity import (
    TINY, compile_reference, jax_repdepth, nhwc_to_torch, strip, torch_to_nhwc)
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

B = 2


@pytest.fixture(scope="module")
def teacher():
    """The whole JAX tree; these tests read its teacher (mono_encoder,
    mono_depth)."""
    return jax_repdepth()


@pytest.mark.parametrize("form", ["train", "merged", "folded"])
def test_replknet_matches_jax(teacher, form):
    params, stats = teacher
    merged = form != "train"
    if merged:
        params, stats = jax_reparam(params, stats)
    x = np.random.RandomState(3).rand(B, TINY.height, TINY.width, 3).astype(
        np.float32)
    jmodel = JRepLKNet(rep_size="t", adpt_test=4, merged=merged)
    v = {"params": params["mono_encoder"], "batch_stats": stats["mono_encoder"]}
    ref = compile_reference(lambda v, x: jmodel.apply(v, x, False), v, x)(v, x)

    model = RepLKNet("t", adpt_test=4, merged=merged).eval()
    model.load_state_dict(
        strip(state_dict_from_jax(params, stats), "mono_encoder"), strict=True)
    if form == "folded":
        model.fold_ffn(torch.float32)
    with torch.inference_mode():
        feats = model(nhwc_to_torch(x))
    assert len(feats) == 4
    for r, f in zip(ref, feats):
        assert f.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_allclose(torch_to_nhwc(f), np.asarray(r), rtol=0,
                                   atol=2e-4)


def test_decoder_matches_jax(teacher):
    params, _ = teacher
    ch = num_ch_enc("t")
    rng = np.random.RandomState(4)
    feats = [rng.rand(B, TINY.height // 4 >> i, TINY.width // 4 >> i,
                      ch[i]).astype(np.float32) for i in range(4)]
    v = {"params": params["mono_depth"]}
    ref = compile_reference(lambda v, f: JDecoder(ch).apply(v, f)[("disp", 0)],
                            v, feats)(v, feats)
    model = DepthDecoderV2(ch).eval()
    model.load_state_dict(
        strip(state_dict_from_jax(params, {}), "mono_depth"), strict=True)
    with torch.inference_mode():
        disp = model([nhwc_to_torch(f) for f in feats])[("disp", 0)]
    assert disp.shape == (B, 1, TINY.height, TINY.width)
    np.testing.assert_allclose(torch_to_nhwc(disp), np.asarray(ref), rtol=0,
                               atol=2e-4)


@pytest.mark.parametrize("hw", [(8, 12), (16, 18), (2, 3), (4, 6)])
def test_resize_nearest_matches_jax(hw):
    """Nearest resize of [B, C, H, W] == ops/resize.resize_nearest on NHWC
    for integer up- and down-factors (exact: both pick floor(i*in/out))."""
    x = np.random.RandomState(7).rand(2, 4, 6, 3).astype(np.float32)
    got = torch_to_nhwc(resize_nearest(nhwc_to_torch(x), *hw))
    np.testing.assert_array_equal(
        got, np.asarray(jax_resize(jnp.asarray(x), *hw)))
    np.testing.assert_array_equal(
        torch_to_nhwc(upsample2x_nearest(nhwc_to_torch(x))),
        np.asarray(jax_up2(jnp.asarray(x))))
