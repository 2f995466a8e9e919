"""Nearest resize of NCHW tensors (JAX counterpart: ops/resize.py).

For integer factors torch's nearest rule (floor(i * in / out)) is the
reference, and `F.interpolate(mode="nearest")` is it.
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
