"""Port student serving path against JAX in f32 at the tiny config
(rep_size "t", 64x96, 96 depth bins): the pose geometry, the matching
encoder (features, lowest-cost disparity, confidence), and
`InferenceSession.predict_depth_multi` / `predict_pose` against the body of
ppeadepth_tpu/serve.py:128-186, merged and unmerged, on the same converted
weights. The pose nets, the bf16 session's f32 modules and the student
path's freedom from jax are in tests/test_torch_student_pose.py.

The whole JAX RepDepth tree comes from `tests.torch_parity.jax_repdepth`
(a numpy seed over the shapes of its init, no compile).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppeadepth_tpu.core.geometry import disp_to_depth
from ppeadepth_tpu.core.geometry import (
    transformation_from_parameters as jax_transform)
from ppeadepth_tpu.models import RepDepth as JRepDepth
from ppeadepth_tpu_torch.ckpt.convert import state_dict_from_jax
from ppeadepth_tpu_torch.core.geometry import transformation_from_parameters
from ppeadepth_tpu_torch.serve import InferenceSession
from tests.torch_parity import (
    TINY, compile_reference, jax_repdepth, nhwc_to_torch, torch_to_nhwc)
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)


B = 2
ATOL = 2e-4  # f32 summation order through the tiny net, as the teacher tests


def rel_pose(axisangle, translation, batch=B):
    """[batch, 4, 4] from one axis-angle and translation (numpy)."""
    T = np.asarray(jax_transform(jnp.asarray([axisangle], jnp.float32),
                                 jnp.asarray([translation], jnp.float32)))
    return np.repeat(T, batch, 0)


def intrinsics(height, width, batch=B):
    """KITTI-style K and its pinv [batch, 4, 4] at the given size."""
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1] = 0.58 * width, 1.92 * height
    K[0, 2], K[1, 2] = 0.5 * width, 0.5 * height
    K = np.repeat(K[None], batch, 0)
    return K, np.linalg.pinv(K).astype(np.float32)


# a non-degenerate pose: x+y+z translation and a small rotation, so no
# sample lands within rounding of the 2-px edge-mask boundary
T_GIVEN = rel_pose([0.01, -0.015, 0.005], [0.03, 0.02, -0.05])


@pytest.fixture(scope="module")
def whole():
    return jax_repdepth()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(11)
    img = rng.rand(B, TINY.height, TINY.width, 3).astype(np.float32)
    # the lookup frame is the current one shifted, so the sweep sees
    # structure
    lk = np.roll(img, (1, 3), axis=(1, 2)) * 0.9 + 0.1 * rng.rand(*img.shape)
    K, invK = intrinsics(TINY.height // 4, TINY.width // 4)
    return img, lk.astype(np.float32), K, invK


def _jax_student(variables, opt, img, lk, K, invK):
    """The body of ppeadepth_tpu/serve.py:151-186 (depth), plus the pose
    net's raw output and the encoder's outputs at T_GIVEN."""
    model = JRepDepth(opt)

    def fn(v, img, lk, K2, invK2, T_given):
        feats = model.apply(v, jnp.concatenate([lk, img], -1), False,
                            method=lambda m, x, t: m.pose_encoder(x, t))
        aa, tt = model.apply(v, [feats], method=lambda m, f: m.pose(f))
        T = jax_transform(aa[:, 0, 0], tt[:, 0, 0], invert=True)
        out, _, conf = model.apply(v, img, lk[:, None], T[:, None], K2, invK2,
                                   0.1, 10.0, False,
                                   method=JRepDepth.forward_multi)
        _, depth = disp_to_depth(out[("disp", 0)][..., 0].astype(jnp.float32),
                                 opt.min_depth, opt.max_depth)
        enc = model.apply(v, img, lk[:, None], T_given[:, None], K2, invK2,
                          0.1, 10.0, False,
                          method=lambda m, *a: m.encoder(*a))
        return depth, conf, aa, tt, enc

    args = (variables, img, lk, K, invK, jnp.asarray(T_GIVEN))
    return jax.tree_util.tree_map(np.asarray, compile_reference(fn, *args)(*args))


@pytest.fixture(scope="module", params=[True, False], ids=["merged", "unmerged"])
def student(request, whole, inputs):
    """(port session, JAX outputs) on the same weights, merged deploy form
    or training form."""
    from ppeadepth_tpu.ckpt.deploy import structural_reparam as jax_reparam

    merged = request.param
    params, stats = whole
    jp, js = jax_reparam(params, stats) if merged else (params, stats)
    ref = _jax_student({"params": jp, "batch_stats": js},
                       TINY.replace(merged=merged), *inputs)
    sess = InferenceSession(TINY, state_dict_from_jax(params, stats),
                            device="cpu", dtype="float32",
                            merge_reparam=merged)
    return sess, ref


def _disp(depth):
    lo, hi = 1.0 / TINY.max_depth, 1.0 / TINY.min_depth
    return (1.0 / depth - lo) / (hi - lo)


@pytest.mark.parametrize("invert", [False, True])
def test_transformation_from_parameters_matches_jax(invert):
    rng = np.random.RandomState(2)
    aa = (rng.randn(5, 3) * 0.3).astype(np.float32)
    aa[0] = 0  # zero rotation: the 1e-7 axis epsilon
    tt = rng.randn(5, 3).astype(np.float32)
    ref = np.asarray(jax_transform(jnp.asarray(aa), jnp.asarray(tt), invert))
    got = transformation_from_parameters(torch.from_numpy(aa),
                                         torch.from_numpy(tt), invert)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_matching_encoder_matches_jax(student, inputs):
    """Features (4 levels), lowest-cost disparity and confidence at a
    non-degenerate pose."""
    sess, ref = student
    img, lk, K, invK = inputs
    jfeats, jlow, jconf = ref[4]
    with torch.inference_mode():
        feats, low, conf = sess.model.encoder(
            nhwc_to_torch(img), nhwc_to_torch(lk)[:, None],
            torch.from_numpy(T_GIVEN)[:, None], torch.from_numpy(K),
            torch.from_numpy(invK), 0.1, 10.0)
    np.testing.assert_array_equal(conf.numpy(), jconf)
    assert 0.05 < jconf.mean() < 0.95  # the mask has both values
    np.testing.assert_allclose(low.numpy(), jlow, rtol=1e-6, atol=0)
    for f, r in zip(feats, jfeats):
        np.testing.assert_allclose(torch_to_nhwc(f), r, rtol=0, atol=ATOL)


def test_predict_depth_multi_matches_jax(student, inputs):
    """Disparity within 2e-4 of JAX on >= 99.9 % of pixels; any pixel
    beyond lies in an image whose confidence mask flipped between the two
    (a sample within rounding of the edge-mask boundary)."""
    sess, ref = student
    jdepth, jconf = ref[0], ref[1]
    img, lk, K, invK = inputs
    depth = sess.predict_depth_multi(img, lk, K, invK)
    assert depth.shape == (B, TINY.height, TINY.width)
    assert depth.dtype == np.float32 and np.isfinite(depth).all()
    close = np.abs(_disp(depth) - _disp(jdepth)) <= ATOL
    assert close.mean() >= 0.999
    if not close.all():
        with torch.inference_mode():
            x, y = nhwc_to_torch(img), nhwc_to_torch(lk)
            T = sess.model.pose_pair(y, x, invert=True)[2]
            _, _, conf = sess.model.forward_multi(
                x, y[:, None], T[:, None], torch.from_numpy(K),
                torch.from_numpy(invK), 0.1, 10.0)
        for b in np.nonzero(~close.all(axis=(1, 2)))[0]:
            assert (conf[b].numpy() != jconf[b]).any()


@pytest.mark.parametrize("invert", [False, True])
def test_predict_pose_matches_jax(student, inputs, invert):
    """serve.py:128-149 on the pair (lookup, current)."""
    sess, ref = student
    aa, tt = ref[2], ref[3]
    img, lk = inputs[:2]
    T = sess.predict_pose(lk, img, invert=invert)
    want = np.asarray(jax_transform(jnp.asarray(aa[:, 0, 0]),
                                    jnp.asarray(tt[:, 0, 0]), invert))
    assert T.shape == (B, 4, 4) and T.dtype == np.float32
    np.testing.assert_allclose(T, want, rtol=0, atol=1e-5)
