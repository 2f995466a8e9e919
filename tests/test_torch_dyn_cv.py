"""The port's DynamicDepth cost volume (`--dyn_cv`) against JAX in f32:
`plane_sweep_cost_volume_dyn` over cv_min on and off x the in-fill
(`set_1`, `pool`, neither) at one lookup frame (two, one of a pose of
zeros, which is skipped: tests/test_torch_dyn_cv_frames.py), with one item
of the batch matching-augmented (its in-fill gated off); its chunking and
the legacy-nearest occlusion masks. The dyn `forward_multi` and the paths
that reach the volume are in tests/test_torch_dyn_cv_paths.py; the split
keeps every port test file behind tests/test_train_step.py in
pytest-xdist's file queue.

The lookup images carry black patches (channel sum below 0.15), so the
occlusion in-fill fires; each case checks that it changed the augmented-off
item and left the gated one alone. Entries whose sample lies within 1e-4
px of the 2-px edge-mask boundary may flip between the JAX matmul and the
port's elementwise coordinates: their pixels are left out, and their share
is checked to stay small.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppeadepth_tpu.ops import cost_volume as JCV
from ppeadepth_tpu_torch.ops import cost_volume as CV
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)


B, H, W, C, D = 2, 12, 16, 8, 8
HF, WF = 4 * H, 4 * W  # the lookup images' full resolution
NEAR = 1e-4  # px: a sample this close to an edge-mask boundary may flip
REL = 1e-5   # |d cost| <= REL x max|ref| off those pixels (f32 rounding)
AUG = np.array([0.0, 1.0], np.float32).reshape(B, 1, 1, 1)  # item 1 augmented
MODES = {"set_1": dict(set_1=True, pool=False),
         "pool": dict(set_1=False, pool=True),
         "neither": dict(set_1=False, pool=False)}


def _pose(rng):
    """A non-degenerate pose: small rotation, x+y+z translation."""
    th = rng.randn(3) * 0.05
    c, s = np.cos(th), np.sin(th)
    Rz = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
    Ry = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
    Rx = np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
    T = np.eye(4)
    T[:3, :3] = Rz @ Ry @ Rx
    T[:3, 3] = rng.randn(3) * [0.1, 0.05, 0.1] + [0.1, 0.05, 0.08]
    return T.astype(np.float32)


def _K(h, w, batch=B):
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 0.58 * w, 1.92 * h, 0.5 * w, 0.5 * h
    K = np.repeat(K[None], batch, 0)
    return K, np.linalg.pinv(K).astype(np.float32)


def black_patches(rng, shape):
    """Images [..., h, w, 3] in [0.2, 1] with black rectangles (about a
    quarter of each image): the occlusion the DOMD module leaves."""
    img = 0.2 + 0.8 * rng.rand(*shape)
    h, w = shape[-3:-1]
    for idx in np.ndindex(*shape[:-3]):
        for _ in range(3):
            y0, x0 = rng.randint(0, h - h // 3), rng.randint(0, w - w // 3)
            img[idx][y0:y0 + h // 3, x0:x0 + w // 3] = 0
    return img.astype(np.float32)


def _inputs(F_):
    rng = np.random.RandomState(5 + F_)
    cur = rng.randn(B, H, W, C).astype(np.float32)
    lk = rng.randn(B, F_, H, W, C).astype(np.float32)
    poses = np.stack([np.stack([_pose(rng) for _ in range(F_)])
                      for _ in range(B)])
    if F_ > 1:
        poses[1, 1] = 0  # a skipped frame
    images = black_patches(rng, (B, F_, HF, WF, 3))
    K, invK = _K(H, W)
    bins = np.array(JCV.compute_depth_bins(0.5, 10.0, D, "log"))
    return cur, lk, poses, K, invK, bins, images


def _near_boundary(poses, K, invK, bins):
    """[B, H, W] bool: a pixel with a sample (float64, any bin or frame)
    within NEAR px of an edge-mask boundary."""
    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    pix = np.stack([gx.ravel(), gy.ravel(), np.ones(H * W)])
    near = np.zeros((B, H * W), bool)
    for f in range(poses.shape[1]):
        P = (K.astype(np.float64) @ poses[:, f])[:, :3]
        A = P[:, :, :3] @ invK[:, :3, :3]
        cam = (A @ pix)[:, None] * bins[None, :, None, None] \
            + P[:, None, :, 3:]
        x = cam[:, :, 0] / (cam[:, :, 2] + 1e-7)
        y = cam[:, :, 1] / (cam[:, :, 2] + 1e-7)
        d = np.minimum.reduce([np.abs(x - 2), np.abs(x - (W - 2)),
                               np.abs(y - 2), np.abs(y - (H - 2))])
        near |= (d < NEAR).any(1)
    return near.reshape(B, H, W)


def _port(inputs, **kw):
    cur, lk, poses, K, invK, bins, images = (torch.from_numpy(a)
                                             for a in inputs)
    with torch.no_grad():
        return [t.numpy() for t in CV.plane_sweep_cost_volume_dyn(
            cur.permute(0, 3, 1, 2), lk.permute(0, 1, 4, 2, 3), poses, K,
            invK, bins, images.permute(0, 1, 4, 2, 3), torch.from_numpy(AUG),
            **kw)]


@pytest.mark.parametrize("F_", [1])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("cv_min", [False, True], ids=["average", "cv_min"])
def test_dyn_cost_volume_matches_jax(cv_min, mode, F_):
    """One lookup frame (two: tests/test_torch_dyn_cv_frames.py)."""
    check_dyn_cost_volume(cv_min, mode, F_)


def check_dyn_cost_volume(cv_min, mode, F_):
    """Cost volume and missing mask within REL of the JAX peak off the
    near-boundary pixels (the missing mask equal there); the in-fill
    changed the volume of item 0 and, gated by aug_mask, not of item 1."""
    inputs = _inputs(F_)
    kw = dict(cv_min=cv_min, pool_r=1, pool_th=0.7, **MODES[mode])
    ref = JCV.plane_sweep_cost_volume_dyn(
        *(jnp.asarray(a) for a in inputs[:6]), jnp.asarray(inputs[6]),
        jnp.asarray(AUG), **kw)
    ref_cost, ref_missing = (np.asarray(r) for r in ref)
    cost, missing = _port(inputs, **kw)
    near = _near_boundary(*inputs[2:6])
    assert near.mean() < 0.02, near.mean()
    far = np.broadcast_to(~near[:, None], cost.shape)
    peak = np.abs(ref_cost).max()
    assert peak > 0
    assert np.abs(cost - ref_cost)[far].max() <= REL * peak
    np.testing.assert_array_equal(missing[far], ref_missing[far])
    assert 0 < ref_missing.mean() < 1

    plain, _ = _port(inputs, cv_min=cv_min, set_1=False, pool=False)
    if mode == "neither":
        return
    assert (cost[0] != plain[0]).any()  # the in-fill fired
    np.testing.assert_array_equal(cost[1], plain[1])  # gated off


@pytest.mark.parametrize("mode", ["set_1", "pool"])
def test_dyn_volume_chunks_agree(mode, monkeypatch):
    """One item a chunk (`_DYN_ITEMS`, as shipped) and the whole batch in
    one chunk give the same volume and missing mask, exactly."""
    inputs = _inputs(2)
    kw = dict(cv_min=False, pool_r=1, pool_th=0.7, **MODES[mode])
    assert CV._DYN_ITEMS == 1
    one = _port(inputs, **kw)
    monkeypatch.setattr(CV, "_DYN_ITEMS", B)
    for got, ref in zip(_port(inputs, **kw), one):
        np.testing.assert_array_equal(got, ref)


def test_occ_masks_select_legacy_nearest():
    """The 48x128 masks are torch's legacy-nearest selection of the
    channel sum < 0.15 pixels, per (item, frame), as JAX `_occ_masks`."""
    images = black_patches(np.random.RandomState(3), (B, 2, 100, 150, 3))
    ref = np.asarray(JCV._occ_masks(jnp.asarray(images), 0.7))
    got = CV.occ_masks(torch.from_numpy(images).permute(0, 1, 4, 2, 3))
    assert got.shape == (B, 2, 48, 128) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0.05 < ref.mean() < 0.95
    assert (ref[:, 0] != ref[:, 1]).any()  # each frame its own mask
