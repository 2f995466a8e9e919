"""Port plane-sweep cost volume against JAX in f32: the depth bins, kernel
C's plain version against `ops/cost_volume._frame_diffs` (backend "lax",
the path tests/test_cost_volume_mxu.py:51-57 holds the Pallas kernel to)
and against the Pallas kernel itself in interpret mode, the whole
`plane_sweep_cost_volume` (averaged and cv_min, a skipped frame), the
confidence mask and lowest-cost disparity, and the wrapper's routing and
input checks. Kernel C itself is held to the plain version on the card
(tests/test_torch_gpu_kernels.py).

Sampled coordinates within rounding of the 2-px edge-mask boundary flip
the mask between implementations (the lax path composes A @ pix as a
matmul, the port in a fixed elementwise order), so entries whose sample
lies within 1e-4 px of a boundary are left out of the comparison, and
their count is checked to stay small.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppeadepth_tpu.kernels.cost_volume_mxu import frame_diffs_batch
from ppeadepth_tpu.ops import cost_volume as JCV
from ppeadepth_tpu_torch import kernels
from ppeadepth_tpu_torch.kernels.cost_volume import plane_sweep, plane_sweep_plain
from ppeadepth_tpu_torch.ops import cost_volume as CV
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

B, H, W, C, D = 2, 16, 32, 16, 32
NEAR = 1e-4  # px: a sample this close to an edge-mask boundary may flip


def _pose(rng, zero=False):
    """Non-degenerate 4x4 pose: small rotation and x+y+z translation."""
    T = np.eye(4, dtype=np.float32)
    if zero:
        return T * 0
    th = rng.randn(3) * 0.03
    c, s = np.cos(th), np.sin(th)
    Rz = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
    Ry = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
    Rx = np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
    T[:3, :3] = Rz @ Ry @ Rx
    T[:3, 3] = rng.randn(3) * np.array([0.05, 0.03, 0.1]) + [0.02, 0.01, 0.03]
    return T


def _K(batch=B):
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 0.58 * W, 1.92 * H, 0.5 * W, 0.5 * H
    K = np.repeat(K[None], batch, 0)
    return K, np.linalg.pinv(K).astype(np.float32)


def _proj(T, K, invK):
    P = (K @ T)[:, :3]
    return (P[:, :, :3] @ invK[:, :3, :3]).astype(np.float32), \
        np.ascontiguousarray(P[:, :, 3]).astype(np.float32)


def _near_boundary(A, t, bins):
    """[B, D, H, W] bool: sample coordinate (float64) within NEAR px of an
    edge-mask boundary."""
    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    pix = np.stack([gx.ravel(), gy.ravel(), np.ones(H * W)]).astype(np.float64)
    cam = (A.astype(np.float64) @ pix)[:, None] * bins.astype(np.float64)[
        None, :, None, None] + t.astype(np.float64)[:, None, :, None]
    x = cam[:, :, 0] / (cam[:, :, 2] + 1e-7)
    y = cam[:, :, 1] / (cam[:, :, 2] + 1e-7)
    d = np.minimum.reduce([np.abs(x - 2), np.abs(x - (W - 2)),
                           np.abs(y - 2), np.abs(y - (H - 2))])
    return (d < NEAR).reshape(B, -1, H, W)


def _features(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    cur = rng.randn(B, H, W, C).astype(np.float32)
    lk = rng.randn(B, H, W, C).astype(np.float32)
    if dtype == "bfloat16":  # bf16-representable values, kept f32 for JAX
        cur = torch.from_numpy(cur).bfloat16().float().numpy()
        lk = torch.from_numpy(lk).bfloat16().float().numpy()
    return cur, lk


def _to_torch(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).permute(0, 3, 1, 2)


def _bins(lo=0.1):
    return np.array(JCV.compute_depth_bins(lo, 10.0, D, "log"))


def _assert_close_off_boundary(got, ref, near, rel):
    far = ~near
    assert near.mean() < 1e-3, near.mean()
    err = np.abs(got - ref)[far].max()
    assert err <= rel * np.abs(ref).max(), err
    assert (ref > 0).mean() > 0.1  # the sweep observes pixels


@pytest.mark.parametrize("binning", ["log", "linear", "inverse"])
def test_depth_bins_match_jax(binning):
    ref = np.asarray(JCV.compute_depth_bins(0.1, 10.0, 96, binning))
    got = CV.compute_depth_bins(0.1, 10.0, 96, binning).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    assert (np.diff(got) > 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frame_diffs_match_lax(dtype):
    """Kernel C's plain version (through the wrapper on CPU tensors) ==
    vmap(_frame_diffs) to 1e-5 of the peak off the mask boundary; bf16
    features are read exactly, so they match JAX on their f32 values."""
    rng = np.random.RandomState(1)
    cur, lk = _features(2, dtype)
    K, invK = _K()
    A, t = _proj(np.stack([_pose(rng) for _ in range(B)]), K, invK)
    bins = _bins()
    ref = np.asarray(jax.vmap(
        lambda cf, lf, a, tt: JCV._frame_diffs(cf, lf, a, tt, jnp.asarray(bins),
                                               H, W, 8))(
        cur.reshape(B, H * W, C), lk, A, t))
    tdt = getattr(torch, dtype)
    got = plane_sweep(_to_torch(cur, tdt), _to_torch(lk, tdt),
                      torch.from_numpy(A), torch.from_numpy(t),
                      torch.from_numpy(bins)).numpy()
    assert got.shape == (B, D, H, W) and got.dtype == np.float32
    _assert_close_off_boundary(got, ref, _near_boundary(A, t, bins), 1e-5)


def test_frame_diffs_match_pallas_interpret():
    """The plain version == the TPU kernel (interpret mode, f32 operands,
    HIGHEST precision) at a tiny size, to 5e-5 of the peak off the mask
    boundary (the kernel's in-tile coordinate math rounds differently)."""
    rng = np.random.RandomState(3)
    cur, lk = _features(4)
    K, invK = _K()
    A, t = _proj(np.stack([_pose(rng) for _ in range(B)]), K, invK)
    bins = _bins()[::4].copy()  # 8 bins keep interpret mode quick
    ref = np.asarray(frame_diffs_batch(
        jnp.asarray(cur.reshape(B, H * W, C)), jnp.asarray(lk), jnp.asarray(A),
        jnp.asarray(t), jnp.asarray(bins), interpret=True, precision="highest",
        compute_dtype="float32"))
    got = plane_sweep_plain(_to_torch(cur), _to_torch(lk), torch.from_numpy(A),
                            torch.from_numpy(t), torch.from_numpy(bins)).numpy()
    _assert_close_off_boundary(got, ref, _near_boundary(A, t, bins), 5e-5)


def _sweep_inputs(seed, frames=2):
    rng = np.random.RandomState(seed)
    cur, _ = _features(seed)
    lks = np.stack([_features(seed + 10 + f)[1] for f in range(frames)], 1)
    poses = np.stack([np.stack([_pose(rng) for _ in range(frames)])
                      for _ in range(B)])
    poses[1, 0] = 0  # item 1 misses its first frame
    K, invK = _K()
    return cur, lks, poses, K, invK


def _near_any_frame(poses, K, invK, bins):
    """[B, H, W]: pixels with a near-boundary sample in any bin or frame
    (the missing->max fill spreads a flip over the pixel's bins)."""
    near = np.zeros((B, H, W), bool)
    for f in range(poses.shape[1]):
        A, t = _proj(poses[:, f], K, invK)
        near |= _near_boundary(A, t, bins).any(1)
    return near


@pytest.mark.parametrize("cv_min", [False, True])
def test_plane_sweep_cost_volume_matches_jax(cv_min):
    """The frame loop, zero-pose skip, count+1e-7 average (or cv_min) and
    missing->max fill == JAX's lax path, two lookup frames."""
    cur, lks, poses, K, invK = _sweep_inputs(5)
    bins = _bins()
    ref_cost, ref_miss = (np.asarray(a) for a in JCV.plane_sweep_cost_volume(
        jnp.asarray(cur), jnp.asarray(lks), jnp.asarray(poses), jnp.asarray(K),
        jnp.asarray(invK), jnp.asarray(bins), cv_min=cv_min, backend="lax"))
    cost, miss = CV.plane_sweep_cost_volume(
        _to_torch(cur), torch.from_numpy(lks).permute(0, 1, 4, 2, 3),
        torch.from_numpy(poses), torch.from_numpy(K), torch.from_numpy(invK),
        torch.from_numpy(bins), cv_min=cv_min)
    far = ~_near_any_frame(poses, K, invK, bins)[:, None].repeat(D, 1)
    assert far.mean() > 0.99
    np.testing.assert_array_equal(miss.numpy()[far], ref_miss[far])
    err = np.abs(cost.numpy() - ref_cost)[far].max()
    assert err <= 1e-5 * np.abs(ref_cost).max(), err
    assert 0 < ref_miss.mean() < 1


def test_confidence_and_lowest_cost_match_jax():
    """On one cost volume fed to both: the same confidence mask, and the
    same argmin bin (first minimum on ties; a tie is planted)."""
    cur, lks, poses, K, invK = _sweep_inputs(6, frames=1)
    bins = _bins(2.0)  # far planes: many pixels see every bin
    cost, miss = (np.array(a) for a in JCV.plane_sweep_cost_volume(
        jnp.asarray(cur), jnp.asarray(lks), jnp.asarray(poses), jnp.asarray(K),
        jnp.asarray(invK), jnp.asarray(bins), backend="lax"))
    cost[0, 3, 5, 7] = cost[0, 9, 5, 7] = cost[0, :, 5, 7].min() - 1e-3
    conf = CV.confidence_mask(torch.from_numpy(cost), torch.from_numpy(miss))
    np.testing.assert_array_equal(
        conf.numpy(), np.asarray(JCV.confidence_mask(cost, miss)))
    assert 0 < conf.numpy().mean() < 1
    low = CV.lowest_cost_disparity(torch.from_numpy(cost), torch.from_numpy(bins))
    ref = np.asarray(JCV.lowest_cost_disparity(cost, bins))
    np.testing.assert_allclose(low.numpy(), ref, rtol=1e-6, atol=0)
    assert low[0, 5, 7] == pytest.approx(1 / bins[3], rel=1e-6)


def test_zero_pose_gives_all_missing():
    """A zero relative pose (missing frame) skips the frame: every entry
    missing, confidence 0, cost 0."""
    cur, lks, _, K, invK = _sweep_inputs(7, frames=1)
    poses = np.zeros((B, 1, 4, 4), np.float32)
    bins = torch.from_numpy(_bins())
    cost, miss = CV.plane_sweep_cost_volume(
        _to_torch(cur), torch.from_numpy(lks).permute(0, 1, 4, 2, 3),
        torch.from_numpy(poses), torch.from_numpy(K), torch.from_numpy(invK),
        bins)
    assert (miss == 1).all() and (cost == 0).all()
    assert (CV.confidence_mask(cost, miss) == 0).all()
    assert (CV.lowest_cost_disparity(cost, bins) == 1 / bins[0]).all()


def test_plane_sweep_routes_cpu_to_plain():
    """CPU tensors take the plain version and launch nothing; the output
    is [B, D, H, W] f32."""
    rng = np.random.RandomState(8)
    cur, lk = _features(9)
    A, t = _proj(np.stack([_pose(rng) for _ in range(B)]), *_K())
    args = (_to_torch(cur), _to_torch(lk), torch.from_numpy(A),
            torch.from_numpy(t), torch.from_numpy(_bins()))
    before = dict(kernels.launch_counts)
    got = plane_sweep(*args)
    assert kernels.launch_counts == before
    torch.testing.assert_close(got, plane_sweep_plain(*args), rtol=0, atol=0)
    assert got.shape == (B, D, H, W) and got.dtype == torch.float32


def _args(**kw):
    cur = torch.zeros(2, 16, 6, 8).contiguous(memory_format=torch.channels_last)
    a = dict(cur=cur, lk=cur.clone(), A=torch.zeros(2, 3, 3), t=torch.zeros(2, 3),
             bins=torch.ones(4))
    a.update(kw)
    return a


@pytest.mark.parametrize("kw,exc", [
    (dict(lk=torch.zeros(2, 16, 6, 9)), ValueError),
    (dict(A=torch.zeros(2, 4, 4)), ValueError),
    (dict(t=torch.zeros(3, 3)), ValueError),
    (dict(bins=torch.ones(2, 2)), ValueError),
    (dict(cur=_args()["cur"].double(), lk=_args()["cur"].double()), TypeError),
    (dict(lk=_args()["cur"].bfloat16()), TypeError),
    (dict(A=torch.zeros(2, 3, 3, dtype=torch.float64)), TypeError),
    (dict(cur=torch.zeros(2, 16, 6, 8), lk=torch.zeros(2, 16, 6, 8)), ValueError),
])
def test_plane_sweep_rejects_bad_inputs(kw, exc):
    with pytest.raises(exc):
        plane_sweep(**_args(**kw))
