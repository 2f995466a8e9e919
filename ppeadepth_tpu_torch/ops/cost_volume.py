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
"""

from __future__ import annotations

import math

import torch

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
