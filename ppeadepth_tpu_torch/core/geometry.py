"""Camera geometry (JAX counterpart: core/geometry.py). Only what the
teacher serving path needs so far."""

from __future__ import annotations


def disp_to_depth(disp, min_depth: float, max_depth: float):
    """Convert a sigmoid disparity in [0, 1] to (scaled_disp, depth).

    scaled_disp lies in [1/max_depth, 1/min_depth]; depth = 1/scaled_disp.
    Reference: layers.py:14-23.
    """
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1.0 / scaled_disp
