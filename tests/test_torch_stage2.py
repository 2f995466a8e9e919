"""The port's stage-2 model (`--dc`) against the JAX package on the CPU, in
f32, with every parameter drawn away from its zero init
(`torch_parity.random_tree`), so a transposed or flipped ConvTranspose
kernel or a wrong adapter wiring cannot hide:

  * `DepthDecoderV2(dc=True)` for every dec_id, forward and the VJP of
    every parameter, at TINY widths (64x96);
  * the dc freeze labels, name for name against `freeze.param_labels`
    through `torch_module_name`, for dec_id 1, 5, 6 and 10 (5 and 6 also at
    rep_size b, whose stage 2 holds blocks 30-35);
  * a whole dc tree that loads with strict=True;
  * a dc session serving teacher and student depth on the CPU.

No JAX step compile: the decoders' forward and VJP and one teacher forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from ppeadepth_tpu.core.geometry import disp_to_depth
from ppeadepth_tpu.models import RepDepth as JRepDepth
from ppeadepth_tpu.models.depth_decoder import DepthDecoderV2 as JDecoder
from ppeadepth_tpu.train.freeze import param_labels as jax_labels
from ppeadepth_tpu_torch.ckpt.convert import state_dict_from_jax, torch_module_name
from ppeadepth_tpu_torch.models import RepDepth
from ppeadepth_tpu_torch.models.depth_decoder import DepthDecoderV2
from ppeadepth_tpu_torch.models.replknet import num_ch_enc
from ppeadepth_tpu_torch.serve import InferenceSession
from ppeadepth_tpu_torch.train.freeze import param_labels
from tests.torch_parity import (
    TINY, compile_reference, jax_repdepth, jax_shapes, nhwc_to_torch,
    random_tree, torch_to_nhwc)
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

B = 2
DC = TINY.replace(dc=True, dec_id=1)
# forward: max|d disp| (disparities in (0, 1)); VJP: per parameter, max|d g|
# <= VJP_REL x max|g| of that parameter
DISP_TOL = 1e-5
VJP_REL = 1e-4


def _feats(rng, ch):
    return [rng.rand(B, TINY.height // 4 >> i, TINY.width // 4 >> i,
                     ch[i]).astype(np.float32) for i in range(4)]


@pytest.mark.parametrize("dec_id", [1, 2, 3, 4, 5, 6, 7, 8, 10])
def test_dc_decoder_matches_jax(dec_id):
    """Forward within DISP_TOL and every parameter's VJP (of the disparity
    against a random cotangent) within VJP_REL of its peak."""
    ch = num_ch_enc("t")
    rng = np.random.RandomState(dec_id)
    feats = _feats(rng, ch)
    jdec = JDecoder(ch, dc=True, dec_id=dec_id, dec_ratio=0.5)
    shapes = jax.eval_shape(lambda: jdec.init(jax.random.PRNGKey(0), feats))
    params = random_tree(shapes["params"], rng)
    cot = rng.randn(B, TINY.height, TINY.width, 1).astype(np.float32)

    def fwd_vjp(p, f, c):
        disp, vjp = jax.vjp(lambda p: jdec.apply({"params": p}, f)[("disp", 0)], p)
        return disp, vjp(c)[0]

    ref, ref_g = compile_reference(fwd_vjp, params, feats, cot)(params, feats, cot)

    model = DepthDecoderV2(ch, dc=True, dec_id=dec_id, dec_ratio=0.5)
    model.load_state_dict(state_dict_from_jax(params, {}), strict=True)
    disp = model([nhwc_to_torch(f) for f in feats])[("disp", 0)]
    assert disp.shape == (B, 1, TINY.height, TINY.width)
    np.testing.assert_allclose(torch_to_nhwc(disp), np.asarray(ref), rtol=0,
                               atol=DISP_TOL)
    disp.backward(nhwc_to_torch(cot))

    ref_g = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, ref_g), {})
    names = dict(model.named_parameters())
    assert set(ref_g) == set(names)
    adapters = [n for n in names if "adapter" in n or "adpt" in n]
    assert adapters
    for n, p in names.items():
        r = ref_g[n].numpy()
        peak = np.abs(r).max()
        assert peak > 0, n
        err = np.abs(p.grad.numpy() - r).max()
        assert err <= VJP_REL * peak, (n, err, peak)


@pytest.mark.parametrize("rep_size,dec_id", [
    ("t", 1), ("t", 5), ("t", 6), ("t", 10), ("b", 5), ("b", 6)])
def test_dc_labels_match_jax(rep_size, dec_id):
    """Every parameter's label equals the JAX package's for the same path
    (the port's names are `torch_module_name` of the flax paths); at rep_size
    b dec_id 5/6 keep the encoder adapters of stage 2's blocks 34/35 and not
    those of blocks 3 or 30-33."""
    opt = DC.replace(rep_size=rep_size, dec_id=dec_id)
    shapes = jax_shapes(opt)["params"]
    ref = {}
    for key, label in traverse_util.flatten_dict(jax_labels(shapes, opt)).items():
        *path, leaf = key
        leaf = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
        ref[f"{torch_module_name(tuple(path))}.{leaf}"] = label
    with torch.device("meta"):
        model = RepDepth(opt)
    got = param_labels(model, opt)
    assert got == ref
    decoders = [n for n in got if n.split(".")[0] in ("depth", "mono_depth")]
    trained = [n for n in decoders if got[n] == "trainable"]
    assert trained and len(trained) < len(decoders)
    assert all("adapter" in n or "adpt" in n for n in trained)
    if rep_size == "b":
        kept = {n.split(".blocks.")[1].split(".")[0] for n in got
                if ".stages.2.blocks." in n and "adapter" in n
                and got[n] == "trainable"}
        assert kept == ({"35"} if dec_id == 5 else {"34", "35"})


@pytest.mark.parametrize("dec_id", [1, 10])
def test_dc_tree_loads_strict(dec_id):
    """A whole JAX dc tree (non-zero adapters and deconvs) loads into the
    port's RepDepth with strict=True, every stage-2 entry with its value."""
    opt = DC.replace(dec_id=dec_id)
    params, stats = jax_repdepth(opt)
    sd = state_dict_from_jax(params, stats)
    model = RepDepth(opt)
    model.load_state_dict(sd, strict=True)
    got = model.state_dict()
    stage2 = [k for k in sd if k.split(".")[0] in ("depth", "mono_depth")
              and ("adapter" in k or "adpt" in k)]
    assert len(stage2) == (2 * 6 if dec_id == 1 else 2 * 8)
    for k in stage2:
        assert got[k].abs().max() > 0 and torch.equal(got[k], sd[k]), k


def test_dc_session_serves_on_cpu():
    """A merged f32 session of a dc tree serves teacher depth equal to the
    JAX teacher forward on the same weights (as disparity, atol 2e-4 as
    tests/test_torch_serve.py), and student depth equal to the port's own
    unmerged forward (atol 2e-4), both finite and of the right shape."""
    params, stats = jax_repdepth(DC)
    sd = state_dict_from_jax(params, stats)
    jmodel = JRepDepth(DC)

    def teacher(v, img):
        out = jmodel.apply(v, img, False, method=JRepDepth.forward_mono)
        return disp_to_depth(out[("disp", 0)][..., 0], DC.min_depth,
                             DC.max_depth)[1]

    rng = np.random.RandomState(11)
    img = rng.rand(B, DC.height, DC.width, 3).astype(np.float32)
    lookup = np.roll(img, (2, 3), (1, 2)).copy()
    v = {"params": params, "batch_stats": stats}
    ref = np.asarray(compile_reference(teacher, v, jnp.asarray(img))(v, img))

    def disp(depth):
        lo, hi = 1.0 / DC.max_depth, 1.0 / DC.min_depth
        return (1.0 / depth - lo) / (hi - lo)

    sess = InferenceSession(DC, sd, device="cpu", dtype="float32")
    depth = sess.predict_depth(img)
    assert depth.shape == (B, DC.height, DC.width) and np.isfinite(depth).all()
    np.testing.assert_allclose(disp(depth), disp(ref), rtol=0, atol=2e-4)

    K = np.repeat(np.eye(4, dtype=np.float32)[None], B, 0)
    K[:, 0, 0], K[:, 1, 1] = 0.58 * DC.width / 4, 1.92 * DC.height / 4
    K[:, 0, 2], K[:, 1, 2] = DC.width / 8, DC.height / 8
    invK = np.linalg.pinv(K).astype(np.float32)
    multi = sess.predict_depth_multi(img, lookup, K, invK)
    plain = InferenceSession(DC, sd, device="cpu", dtype="float32",
                             merge_reparam=False)
    assert multi.shape == (B, DC.height, DC.width) and np.isfinite(multi).all()
    np.testing.assert_allclose(
        disp(multi), disp(plain.predict_depth_multi(img, lookup, K, invK)),
        rtol=0, atol=2e-4)
