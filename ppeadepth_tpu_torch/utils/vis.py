"""Depth visualisation (JAX counterpart, of which this is a copy:
ppeadepth_tpu/utils/vis.py; the reference's vis.py:1-20): normalise a
disparity or depth map and apply the plasma colormap, or, without
matplotlib, a plasma-like ramp."""

from __future__ import annotations

import numpy as np


def colorize(value: np.ndarray, vmin=None, vmax=None) -> np.ndarray:
    """value: [H, W] -> uint8 RGB [H, W, 3] (plasma)."""
    value = np.asarray(value, dtype=np.float32)
    vmin = np.min(value) if vmin is None else vmin
    vmax = np.max(value) if vmax is None else vmax
    value = (value - vmin) / max(vmax - vmin, 1e-8)
    value = np.clip(value, 0.0, 1.0)
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        # matplotlib-free fallback: a perceptual-ish ramp
        r = np.clip(1.5 * value, 0, 1)
        g = np.clip(1.5 * value - 0.25, 0, 1) ** 1.5
        b = np.clip(1.0 - value * 1.2, 0, 1)
        return (np.stack([r, g, b], -1) * 255).astype(np.uint8)
    rgba = plt.get_cmap("plasma", 256)(value)
    return (rgba[..., :3] * 255).astype(np.uint8)
