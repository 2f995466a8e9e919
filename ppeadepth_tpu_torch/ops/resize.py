"""Resizes of NCHW tensors (JAX counterpart: ops/resize.py).

For integer factors torch's nearest rule (floor(i * in / out)) is the
reference, and `F.interpolate(mode="nearest")` is it. Bilinear resizes use
half-pixel centres (align_corners=False) without antialiasing, which is
`jax.image.resize(method="linear")` on an upscale (the loss's only use:
the disparity to full resolution, trainer.py:888-890).
"""

from __future__ import annotations

import torch.nn.functional as F


def upsample2x_nearest(x):
    """Nearest 2x upsample of [B, C, H, W]."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def resize_nearest(x, height: int, width: int):
    """Nearest resize of [B, C, H, W] to (height, width)."""
    if x.shape[-2:] == (height, width):
        return x
    return F.interpolate(x, size=(height, width), mode="nearest")


def resize_bilinear(x, height: int, width: int):
    """Bilinear (align_corners=False) resize of [B, C, H, W] to (height,
    width)."""
    if x.shape[-2:] == (height, width):
        return x
    return F.interpolate(x, size=(height, width), mode="bilinear",
                         align_corners=False, antialias=False)
