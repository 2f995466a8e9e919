"""The port's legacy ManyDepth pair (models/resnet_matching.py:
ResnetEncoderMatching + the Monodepth2 DepthDecoder) against the JAX
modules in f32 at 64x96, 8 linear bins, B=2, one lookup frame, with drawn
BN statistics; the legacy names that `ckpt/convert` writes, read back by
the JAX importer; and a legacy-format file loaded strictly.

The JAX reference is compiled (`torch_parity.compile_reference`), once
for the encoder and once for the decoder: on the CPU that takes less time
than running them eagerly, where every operation compiles on its first
use.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from ppeadepth_tpu.ckpt import torch_import as TI
from ppeadepth_tpu.core.geometry import (
    transformation_from_parameters as jax_transform)
from ppeadepth_tpu.models.resnet_matching import (
    DepthDecoder as JDepthDecoder, ResnetEncoderMatching as JEncoder)
from ppeadepth_tpu_torch.ckpt.convert import legacy_state_dict_from_jax
from ppeadepth_tpu_torch.eval_depth_ori import legacy_state_dict
from ppeadepth_tpu_torch.models.resnet_matching import (
    DepthDecoder, ResnetEncoderMatching)
from tests.torch_parity import (
    compile_reference, nhwc_to_torch, random_tree, torch_to_nhwc)
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

H, W, B, BINS = 64, 96, 2, 8
ATOL = 2e-4  # f32 summation order through the net, as test_torch_student.py
MIN_BIN, MAX_BIN = 0.1, 20.0


def _args():
    """(current [B, H, W, 3], lookup [B, 1, H, W, 3], poses [B, 1, 4, 4],
    K, invK [B, 4, 4] at 1/4 scale), numpy; the lookup frame is the
    current one shifted, and the pose non-degenerate (rotation and an
    x+y+z translation), so no sample sits on the edge-mask boundary."""
    rng = np.random.RandomState(5)
    img = rng.rand(B, H, W, 3).astype(np.float32)
    lk = (np.roll(img, (1, 3), (1, 2)) * 0.9
          + 0.1 * rng.rand(B, H, W, 3)).astype(np.float32)
    T = np.asarray(jax_transform(jnp.asarray([[0.01, -0.015, 0.005]] * B),
                                 jnp.asarray([[0.03, 0.02, -0.05]] * B)))
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1] = 0.58 * W / 4, 1.92 * H / 4
    K[0, 2], K[1, 2] = 0.5 * W / 4, 0.5 * H / 4
    K = np.repeat(K[None], B, 0)
    return (img, lk[:, None], T[:, None].astype(np.float32), K,
            np.linalg.pinv(K).astype(np.float32))


@pytest.fixture(scope="module")
def legacy():
    """JAX outputs (encoder, decoder) of drawn trees, compiled, and the
    port's modules loaded from them through `legacy_state_dict_from_jax`."""
    args = _args()
    jargs = tuple(jnp.asarray(a) for a in args) + (MIN_BIN, MAX_BIN)
    jenc = JEncoder(num_depth_bins=BINS, depth_binning="linear")
    jdec = JDepthDecoder()
    key = jax.random.PRNGKey(0)
    rng = np.random.RandomState(6)
    enc_s = jax.eval_shape(lambda: jenc.init(key, *jargs))
    enc_v = {k: random_tree(v, rng) for k, v in enc_s.items()}
    feats, lowest, conf = compile_reference(jenc.apply, enc_v, *jargs)(
        enc_v, *jargs)
    dec_s = jax.eval_shape(lambda: jdec.init(key, feats))
    dec_v = {k: random_tree(v, rng) for k, v in dec_s.items()}
    disps = compile_reference(jdec.apply, dec_v, feats)(dec_v, feats)
    enc = ResnetEncoderMatching(18, BINS, "linear").eval()
    enc.load_state_dict(legacy_state_dict_from_jax(
        enc_v["params"], enc_v["batch_stats"], "encoder"), strict=True)
    dec = DepthDecoder().eval()
    dec.load_state_dict(legacy_state_dict_from_jax(
        dec_v["params"], {}, "decoder"), strict=True)
    ref = ([np.asarray(f) for f in feats], np.asarray(lowest),
           np.asarray(conf), {k: np.asarray(v) for k, v in disps.items()})
    return args, (enc_v, dec_v), (enc, dec), ref


def test_encoder_decoder_match_jax(legacy):
    """Every feature level, lowest-cost disparity, confidence and the 4
    disparity scales."""
    (img, lk, T, K, invK), _, (enc, dec), (jfeats, jlow, jconf, jdisps) = legacy
    with torch.inference_mode():
        feats, low, conf = enc(
            nhwc_to_torch(img), torch.from_numpy(lk).permute(0, 1, 4, 2, 3),
            torch.from_numpy(T), torch.from_numpy(K), torch.from_numpy(invK),
            MIN_BIN, MAX_BIN)
        disps = dec(feats)
    assert [f.shape[1] for f in feats] == list(enc.num_ch_enc)
    for i, (f, r) in enumerate(zip(feats, jfeats)):
        np.testing.assert_allclose(torch_to_nhwc(f), r, rtol=0, atol=ATOL,
                                   err_msg=f"feature level {i}")
    np.testing.assert_array_equal(conf.numpy(), jconf)
    assert 0.05 < jconf.mean() < 0.95  # the mask has both values
    np.testing.assert_allclose(low.numpy(), jlow, rtol=1e-6, atol=0)
    assert sorted(disps) == sorted(jdisps) == [("disp", s) for s in range(4)]
    for k, r in jdisps.items():
        assert disps[k].shape == (B, 1, H >> k[1], W >> k[1])
        np.testing.assert_allclose(torch_to_nhwc(disps[k]), r, rtol=0,
                                   atol=ATOL, err_msg=str(k))


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_jax_importer_reads_the_legacy_names(legacy, kind):
    """The names the port writes are the legacy files' own: JAX's
    `translate_legacy_state_dict` + `map_state_dict` find every leaf,
    with the values they came from."""
    _, (enc_v, dec_v), (enc, dec), _ = legacy
    v, module = (enc_v, enc) if kind == "encoder" else (dec_v, dec)
    sd = {k: t.numpy() for k, t in module.state_dict().items()
          if torch.is_floating_point(t)}
    params, stats, loaded, missing = TI.map_state_dict(
        TI.translate_legacy_state_dict(sd, kind), v["params"],
        v.get("batch_stats", {}))
    assert not missing, missing[:5]
    want = {**traverse_util.flatten_dict(v["params"]),
            **traverse_util.flatten_dict(v.get("batch_stats", {}))}
    assert loaded == len(want)
    got = {**traverse_util.flatten_dict(params),
           **traverse_util.flatten_dict(stats)}
    for k, a in want.items():
        np.testing.assert_array_equal(got[k], a, err_msg=str(k))


def test_legacy_file_loads_strictly(legacy, tmp_path):
    """encoder.pth as the reference writes it (the weights, BN counters,
    the dead pre-matching conv, the backprojector's pixel grids, and the
    bin range, height and width as extras) loads strictly; a stray tensor
    is refused."""
    _, _, (enc, _), _ = legacy
    blob = dict(enc.state_dict())
    blob["prematching_conv.0.weight"] = torch.zeros(16, 64, 1, 1)
    blob["backprojector.id_coords"] = torch.zeros(2, H // 4, W // 4)
    blob["projector.eps"] = torch.tensor(1e-7)
    blob.update(min_depth_bin=torch.tensor(0.15), max_depth_bin=18.0,
                height=H, width=W)
    path = tmp_path / "encoder.pth"
    torch.save(blob, str(path))
    sd, extras = legacy_state_dict(str(path))
    fresh = ResnetEncoderMatching(18, BINS, "linear")
    fresh.load_state_dict(sd, strict=True)
    for k, t in enc.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], t), k
    assert float(extras["min_depth_bin"]) == pytest.approx(0.15)
    assert extras["max_depth_bin"] == 18.0 and extras["height"] == H
    blob["reduce_conv.2.weight"] = torch.zeros(1)
    torch.save(blob, str(path))
    with pytest.raises(RuntimeError, match="Unexpected key"):
        fresh.load_state_dict(legacy_state_dict(str(path))[0], strict=True)
