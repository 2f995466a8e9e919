"""Bilinear grid sampling, align_corners=True, NHWC (JAX counterpart:
ops/sampling.py `grid_sample`; reference F.grid_sample in trainer.py:904-914
and replk_matching.py:163-165).

A gather-based, differentiable copy of the JAX arithmetic: the same
unnormalisation, clamp, floor and corner blend, so autograd gives the
reference's one-sided derivative at integer coordinates and, in border
mode, no gradient past the clamped right and bottom borders. It is the
plain version of kernel D (`kernels.warp.warp_border`).
"""

from __future__ import annotations

import torch


def _unnormalize(coord, size: int):
    """align_corners=True: [-1, 1] -> [0, size - 1]."""
    return (coord + 1.0) * 0.5 * (size - 1)


def grid_sample(img, grid, padding_mode: str = "border"):
    """Bilinear sample `img` at normalised `grid` locations.

    img: [B, H, W, C]; grid: [B, Ho, Wo, 2], last axis (x, y) in [-1, 1].
    padding_mode: "border" or "zeros". Returns [B, Ho, Wo, C]."""
    B, H, W, C = img.shape
    x = _unnormalize(grid[..., 0], W)
    y = _unnormalize(grid[..., 1], H)
    if padding_mode == "border":
        x = x.clamp(0.0, W - 1)
        y = y.clamp(0.0, H - 1)
    elif padding_mode != "zeros":
        raise ValueError(f"unsupported padding_mode: {padding_mode}")

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    # clamped before the cast so a far-off coordinate cannot overflow
    x0i = x0.detach().clamp(-2, W).long()
    y0i = y0.detach().clamp(-2, H).long()
    x1i, y1i = x0i + 1, y0i + 1
    flat = img.reshape(B, H * W, C)
    items = torch.arange(B, device=img.device)[:, None]

    def gather(yi, xi):
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        return flat[items, idx.reshape(B, -1)].reshape(*grid.shape[:3], C)

    def valid(yi, xi):
        return ((xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
                ).to(img.dtype)[..., None]

    w00 = (1 - wx) * (1 - wy)
    w01 = wx * (1 - wy)
    w10 = (1 - wx) * wy
    w11 = wx * wy
    if padding_mode == "zeros":
        w00 = w00 * valid(y0i, x0i)
        w01 = w01 * valid(y0i, x1i)
        w10 = w10 * valid(y1i, x0i)
        w11 = w11 * valid(y1i, x1i)
    return (gather(y0i, x0i) * w00 + gather(y0i, x1i) * w01
            + gather(y1i, x0i) * w10 + gather(y1i, x1i) * w11)
