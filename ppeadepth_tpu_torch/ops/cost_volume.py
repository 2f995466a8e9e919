"""Batched plane-sweep cost volume, ManyDepth-style (JAX counterpart:
ops/cost_volume.py; reference replk_matching.py:96-287).

  * one 3x3 `A = (K @ T)[:3, :3] @ invK[:3, :3]` and one `t = (K @ T)[:3, 3]`
    per (item, frame); for depth plane d the sample of pixel p is at
    `(A @ p) * d + t`;
  * zeros-padding bilinear warp of the lookup features, align_corners
    pixel coordinates;
  * L1 diff averaged over channels, masked by a 2-px edge mask on the
    sampled coordinate and a 2-px border of the current frame
    (replk_matching.py:169-182);
  * frames with an all-zero relative pose are skipped; costs are averaged
    over observed frames (count + 1e-7), or min-combined under `cv_min`;
    missing values (cost 0) become the per-pixel max over bins.

The per-frame diff volume is kernel C (`kernels.cost_volume.plane_sweep`);
`frame_diffs` below is its plain version. Everything here is
gradient-free in the reference (torch.no_grad).

`plane_sweep_cost_volume_dyn` is the DynamicDepth variant (`--dyn_cv`):
the occluded entries of the warped features are filled in before the
diff. The JAX package runs it on lax with no Pallas kernel, and here it is
plain torch, one item at a time; kernel C does not run under it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.geometry import pixel_grid
from ..kernels.cost_volume import plane_sweep

# bins per chunk of the plain version: bounds its [B, chunk * HW, C]
# f32 intermediates (252 MB each at B=8, C=128, 640x192)
_BIN_CHUNK = 8
_EPS = 1e-7  # added to the projected depth, as kernel C and JAX do


def compute_depth_bins(min_depth_bin, max_depth_bin, num_bins: int,
                       binning: str = "log", device=None):
    """Depth hypotheses [num_bins] f32 from scalar min/max
    (replk_matching.py:96-125): 'log' exp(log(min) + i/N * log(max/min)),
    'linear', and 'inverse' (ascending in depth)."""
    min_d = torch.as_tensor(min_depth_bin, dtype=torch.float32, device=device)
    max_d = torch.as_tensor(max_depth_bin, dtype=torch.float32, device=device)
    i = torch.arange(num_bins, dtype=torch.float32, device=device)
    if binning == "log":
        return torch.exp(torch.log(min_d) + torch.log(max_d / min_d) * i / num_bins)
    if binning == "linear":
        return min_d + (max_d - min_d) * i / (num_bins - 1)
    if binning == "inverse":
        inv = 1.0 / max_d + (1.0 / min_d - 1.0 / max_d) * i / (num_bins - 1)
        return torch.flip(1.0 / inv, (0,))
    raise NotImplementedError(binning)


def sample_bilinear_zeros(img, x, y):
    """Zeros-padding bilinear sample (JAX `_sample_one_zeros`).

    img: [B, H, W, C]; x, y: [B, N] pixel coordinates (align_corners).
    Returns [B, N, C] in img's dtype. Each corner is weighted by its own
    validity, so a sample half outside the image keeps its inside part."""
    B, H, W, C = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    # clamped before the cast so a far-off coordinate stays invalid on
    # both corners and never overflows the integer
    x0i = x0.clamp(-2, W).long()
    y0i = y0.clamp(-2, H).long()
    flat = img.reshape(B, H * W, C)
    items = torch.arange(B, device=img.device)[:, None]

    def corner(yi, xi):
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        return flat[items, idx]

    def valid(i, n):
        return ((i >= 0) & (i <= n - 1)).to(img.dtype)[..., None]

    vx0, vx1 = valid(x0i, W), valid(x0i + 1, W)
    vy0, vy1 = valid(y0i, H), valid(y0i + 1, H)
    t00, t01 = corner(y0i, x0i), corner(y0i, x0i + 1)
    b00, b01 = corner(y0i + 1, x0i), corner(y0i + 1, x0i + 1)
    top = (t00 * (1 - wx) * vx0 + t01 * wx * vx1) * vy0
    bot = (b00 * (1 - wx) * vx0 + b01 * wx * vx1) * vy1
    return top * (1 - wy) + bot * wy


def project(A, t, bins, H: int, W: int):
    """Sample coordinates of every (item, bin, pixel): x, y [B, D, H*W].

    `A @ (gx, gy, 1)` is written out as (a0*gx + a1*gy) + a2, the order
    kernel C uses, so the plain version and the kernel round the
    coordinates alike and the edge mask flips in neither."""
    pix = pixel_grid(H, W, device=A.device)
    base = (A[:, :, 0:1] * pix[0] + A[:, :, 1:2] * pix[1]) + A[:, :, 2:3]
    cam = base[:, None] * bins[None, :, None, None] + t[:, None, :, None]
    z = cam[:, :, 2] + _EPS
    return cam[:, :, 0] / z, cam[:, :, 1] / z


def frame_diffs(cur, lk, A, t, bins):
    """Edge-masked L1 diffs of one lookup frame (JAX `_frame_diffs`, whole
    batch): the plain version of kernel C.

    cur, lk: [B, H, W, C] f32; A: [B, 3, 3]; t: [B, 3]; bins: [D].
    Returns [B, D, H, W] f32."""
    B, H, W, C = lk.shape
    cur_flat = cur.reshape(B, 1, H * W, C)
    ys = torch.arange(H, device=cur.device)[:, None]
    xs = torch.arange(W, device=cur.device)[None, :]
    cur_border = ((ys >= 2) & (ys < H - 2) & (xs >= 2) & (xs < W - 2)
                  ).to(torch.float32).reshape(-1)
    out = []
    for d0 in range(0, bins.shape[0], _BIN_CHUNK):
        bins_c = bins[d0:d0 + _BIN_CHUNK]
        n = bins_c.shape[0]
        x, y = project(A, t, bins_c, H, W)  # [B, n, HW]
        warped = sample_bilinear_zeros(
            lk, x.reshape(B, -1), y.reshape(B, -1)).reshape(B, n, H * W, C)
        diff = torch.mean(torch.abs(warped - cur_flat), dim=-1)
        edge = ((x >= 2.0) & (x <= W - 2) & (y >= 2.0) & (y <= H - 2)
                ).to(diff.dtype)
        out.append(diff * edge * cur_border)
    return torch.cat(out, 1).reshape(B, -1, H, W)


def plane_sweep_cost_volume(current_feats, lookup_feats, rel_poses, K, invK,
                            depth_bins, cv_min: bool = False):
    """Cost volume over hypothesised depth planes.

    current_feats: [B, C, H, W]; lookup_feats: [B, F, C, H, W] (bf16 or
    f32; kernel C reads either and computes in f32, the JAX path's f32
    upcast being exact); rel_poses: [B, F, 4, 4] current->lookup; K, invK:
    [B, 4, 4] at the features' scale; depth_bins: [D] ascending.
    cv_min: min over frames instead of the average (DynamicDepth
    `--cv_min`).

    Returns (cost_volume [B, D, H, W] f32, missing_mask [B, D, H, W])."""
    cost = counts = None
    for f in range(lookup_feats.shape[1]):
        T = rel_poses[:, f].float()
        P = (K.float() @ T)[:, :3, :]
        A = (P[:, :, :3] @ invK[:, :3, :3].float()).contiguous()
        t = P[:, :, 3].contiguous()
        lk = lookup_feats[:, f].contiguous(memory_format=torch.channels_last)
        diffs = plane_sweep(current_feats, lk, A, t, depth_bins)
        valid = (T.abs().sum((1, 2)) > 0).to(torch.float32)
        diffs = diffs * valid[:, None, None, None]
        if cv_min:
            # zeros (unobserved) must not win the min
            d = torch.where(diffs == 0, math.inf, diffs)
            cost = d if cost is None else torch.minimum(cost, d)
        else:
            seen = (diffs > 0).to(torch.float32)
            cost = diffs if cost is None else cost + diffs
            counts = seen if counts is None else counts + seen
    if cv_min:
        cost = torch.where(torch.isinf(cost), 0.0, cost)
    else:
        cost = cost / (counts + 1e-7)
    missing = (cost == 0).to(torch.float32)
    cost_max = cost.amax(dim=1, keepdim=True)
    cost = cost * (1 - missing) + cost_max * missing
    return cost, missing


# the occlusion mask's fixed grid: the reference resamples it to 48x128
# whatever the matching resolution (replk_matching_adapter.py:166); the
# warp that reads it works in normalised coordinates, so the constant
# reproduces the reference at any model size
_OCC_HW = (48, 128)
_OCC_DARK = 0.15  # a lookup pixel whose channel sum is below this is occluded
# items of the batch a chunk of the dyn volume: one, as JAX's `lax.map`.
# Four a chunk took 114.621 ms a B=12 stage-2 call against 118.499, with
# 10.356 GiB of transients against 2.691, and raised the --dyn_cv step's
# peak from 15.9 to 20.8 GiB (PERF.md section 6): the volume is bound by
# its bytes, not by its launches
_DYN_ITEMS = 1


def occ_masks(lookup_images):
    """Per-(item, frame) occlusion masks on the fixed 48x128 grid (JAX
    `_occ_masks`): pixels that DOMD blacked out (channel sum < 0.15),
    resampled by torch's legacy nearest (src = floor(dst * in / out)).

    Each frame has its own mask, indexed (b, f); the reference's F > 1
    indexing of the stacked masks (replk_matching_adapter.py:171, 199) is
    not copied. At F = 1, the only count the reference ran, the two agree.

    lookup_images: [B, F, 3, H, W] -> bool [B, F, 48, 128]."""
    H, W = lookup_images.shape[-2:]
    oh, ow = _OCC_HW
    dev = lookup_images.device
    occ = lookup_images.sum(2) < _OCC_DARK  # [B, F, H, W]
    ridx = torch.arange(oh, device=dev) * H // oh
    cidx = torch.arange(ow, device=dev) * W // ow
    return occ[:, :, ridx][:, :, :, cidx]


def frame_diffs_dyn(cur, lk, occ, x, y, fill_gate, set_1: bool, pool: bool,
                    pool_r: int, pool_th: float):
    """Edge-masked L1 diffs of n (item, frame) pairs with the DynamicDepth
    in-fill applied to the warped features before the diff (JAX
    `_frame_diffs_dyn`; match_features_dyn, replk_matching_adapter.py:
    187-236).

    cur, lk: [n, H, W, C] f32; occ: [n, 48, 128] bool; x, y: [n, D, H*W]
    sample coordinates (`project`); fill_gate: [n] bool, False for a
    matching-augmented item (:199). Returns [n, D, H, W].

    The whole [n, D, H*W, C] warped tensor is materialised: the pool's
    window spans neighbouring depth bins."""
    n, H, W, C = lk.shape
    D = x.shape[1]
    warped = sample_bilinear_zeros(lk, x.reshape(n, -1),
                                   y.reshape(n, -1)).reshape(n, D, H * W, C)
    if set_1 or pool:
        # the occlusion mask warped through the same sample locations:
        # normalised coordinates are shared, so the pixel coordinates
        # rescale to the mask's own grid (align_corners)
        oh, ow = _OCC_HW
        xo = x * ((ow - 1) / max(W - 1, 1))
        yo = y * ((oh - 1) / max(H - 1, 1))
        occ_w = sample_bilinear_zeros(occ.float()[..., None],
                                      xo.reshape(n, -1), yo.reshape(n, -1))
        m = ((occ_w.reshape(n, D, H * W) > pool_th)
             & fill_gate[:, None, None])[..., None]
        if set_1:
            # :203 warped[mask] = 1.0, every channel
            warped = torch.where(m, 1.0, warped)
        else:
            # :205-208: the occluded entries zeroed, a 3-D max-pool over
            # (depth, h, w) per channel (max_pool3d pads with -inf, as the
            # JAX reduce_window's SAME padding), and the in-fill from it.
            # [n, C, D, H, W] is a channels_last_3d view of the bytes
            xz = torch.where(m, 0.0, warped).reshape(n, D, H, W, C)
            pooled = F.max_pool3d(xz.permute(0, 4, 1, 2, 3), 2 * pool_r + 1,
                                  stride=1, padding=pool_r)
            del xz
            pooled = pooled.permute(0, 2, 3, 4, 1).reshape(n, D, H * W, C)
            warped = torch.where(m, pooled, warped)
    diff = torch.mean(torch.abs(warped - cur.reshape(n, 1, H * W, C)), dim=-1)
    edge = ((x >= 2.0) & (x <= W - 2) & (y >= 2.0) & (y <= H - 2)).float()
    ys = torch.arange(H, device=x.device)[:, None]
    xs = torch.arange(W, device=x.device)[None, :]
    cur_border = ((ys >= 2) & (ys < H - 2) & (xs >= 2) & (xs < W - 2)
                  ).float().reshape(-1)
    return (diff * edge * cur_border).reshape(n, D, H, W)


def plane_sweep_cost_volume_dyn(current_feats, lookup_feats, rel_poses, K,
                                invK, depth_bins, lookup_images, aug_mask,
                                cv_min: bool = False, set_1: bool = False,
                                pool: bool = True, pool_r: int = 1,
                                pool_th: float = 0.7,
                                set_missing_to_max: bool = True):
    """DynamicDepth cost volume (JAX `plane_sweep_cost_volume_dyn`;
    match_features_dyn, replk_matching_adapter.py:163-258): per lookup
    frame, warp the features, fill in the DOMD-occluded entries (`set_1`:
    1.0; `pool`: a 3-D max-pool of the unoccluded neighbourhood), then
    diff; frames combine by min (`cv_min`) or the observed-count average.

    current_feats: [B, C, H, W]; lookup_feats: [B, F, C, H, W] (any float
    dtype, computed in f32); rel_poses: [B, F, 4, 4]; K, invK: [B, 4, 4]
    at the features' scale; depth_bins: [D]; lookup_images: [B, F, 3, Hf,
    Wf] at full resolution (black = occluded); aug_mask: [B, 1, 1, 1] (1:
    a matching-augmented item, whose in-fill is skipped, :199).

    Returns (cost_volume [B, D, H, W] f32, missing_mask [B, D, H, W]). The
    batch runs `_DYN_ITEMS` items at a time, as JAX's `lax.map`, to bound
    the materialised warps."""
    B, _, H, W = current_feats.shape
    cur = current_feats.float().permute(0, 2, 3, 1)  # [B, H, W, C]
    occ = occ_masks(lookup_images)
    fill_gate = aug_mask.reshape(B) == 0
    # the reference's sentinel for "unobserved" under cv_min is 1.0 (:172,
    # :236-243): initialised to ones, zeros set to 1.0 before each min, 1.0
    # set to 0 after the frames. It also drops an observed best diff >= 1.0
    # as missing; kept as the reference has it (the non-dyn volume's inf
    # sentinel does not)
    cost = torch.full((B, depth_bins.shape[0], H, W), float(cv_min),
                      device=cur.device)
    counts = torch.zeros_like(cost)
    for f in range(lookup_feats.shape[1]):
        T = rel_poses[:, f].float()
        P = (K.float() @ T)[:, :3, :]
        A = P[:, :, :3] @ invK[:, :3, :3].float()
        x, y = project(A, P[:, :, 3], depth_bins, H, W)  # [B, D, HW]
        lk = lookup_feats[:, f].float().permute(0, 2, 3, 1)
        diffs = torch.cat([
            frame_diffs_dyn(cur[s], lk[s], occ[s, f], x[s], y[s],
                            fill_gate[s], set_1, pool, pool_r, pool_th)
            for s in (slice(i, i + _DYN_ITEMS) for i in range(0, B, _DYN_ITEMS))])
        valid = (T.abs().sum((1, 2)) > 0).float()
        diffs = diffs * valid[:, None, None, None]
        if cv_min:
            cost = torch.minimum(cost, torch.where(diffs == 0, 1.0, diffs))
        else:
            cost = cost + diffs
            counts = counts + (diffs > 0).float()
    if cv_min:
        cost = torch.where(cost == 1.0, 0.0, cost)
    else:
        cost = cost / (counts + 1e-7)
    missing = (cost == 0).float()
    if set_missing_to_max:
        cost_max = cost.amax(dim=1, keepdim=True)
        cost = cost * (1 - missing) + cost_max * missing
    return cost, missing


def confidence_mask(cost_volume, missing_mask):
    """1 where all D bins were observed, else 0: [B, H, W]
    (replk_matching.py:242-249)."""
    observed = (cost_volume * (1 - missing_mask)) > 0
    return (observed.sum(1) == cost_volume.shape[1]).to(cost_volume.dtype)


def lowest_cost_disparity(cost_volume, depth_bins):
    """1/depth at the argmin bin, zeros ignored: [B, H, W]
    (replk_matching.py:283-287). Ties go to the first bin, as in JAX."""
    viz = torch.where(cost_volume == 0, 100.0, cost_volume)
    return 1.0 / depth_bins[torch.argmin(viz, dim=1)]
