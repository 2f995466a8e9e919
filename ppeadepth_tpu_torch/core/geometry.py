"""Camera geometry (JAX counterpart: core/geometry.py): what the serving
paths need so far. Reference: layers.py:14-100."""

from __future__ import annotations

import torch


def disp_to_depth(disp, min_depth: float, max_depth: float):
    """Convert a sigmoid disparity in [0, 1] to (scaled_disp, depth).

    scaled_disp lies in [1/max_depth, 1/min_depth]; depth = 1/scaled_disp.
    Reference: layers.py:14-23.
    """
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1.0 / scaled_disp


def rot_from_axisangle(vec):
    """Axis-angle (Rodrigues) [..., 3] -> 4x4 rotation [..., 4, 4], with
    the reference's 1e-7 axis-normalisation epsilon (layers.py:61-100)."""
    angle = torch.linalg.norm(vec, dim=-1, keepdim=True)
    axis = vec / (angle + 1e-7)
    ca = torch.cos(angle)[..., 0]
    sa = torch.sin(angle)[..., 0]
    C = 1.0 - ca
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    xs, ys, zs = x * sa, y * sa, z * sa
    xC, yC, zC = x * C, y * C, z * C
    xyC, yzC, zxC = x * yC, y * zC, z * xC
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    rot = torch.stack([
        x * xC + ca, xyC - zs, zxC + ys, zero,
        xyC + zs, y * yC + ca, yzC - xs, zero,
        zxC - ys, yzC + xs, z * zC + ca, zero,
        zero, zero, zero, one,
    ], dim=-1)
    return rot.reshape(vec.shape[:-1] + (4, 4))


def get_translation_matrix(t):
    """Translation [..., 3] -> 4x4 matrix (layers.py:45-58)."""
    T = torch.eye(4, dtype=t.dtype, device=t.device).expand(
        t.shape[:-1] + (4, 4)).clone()
    T[..., :3, 3] = t
    return T


def transformation_from_parameters(axisangle, translation, invert: bool = False):
    """(axisangle, translation) [..., 3] -> 4x4 SE3 transform. `invert`
    transposes R, negates t and swaps the product order, as the reference
    does (layers.py:26-42)."""
    R = rot_from_axisangle(axisangle)
    t = translation
    if invert:
        R = R.transpose(-1, -2)
        t = -t
    T = get_translation_matrix(t)
    return R @ T if invert else T @ R


def pixel_grid(height: int, width: int, dtype=torch.float32, device=None):
    """Homogeneous pixel grid [3, H*W] with rows (x, y, 1), row-major over
    (y, x) (BackprojectDepth's buffer, layers.py:149-161)."""
    ys, xs = torch.meshgrid(torch.arange(height, dtype=dtype, device=device),
                            torch.arange(width, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1),
                        torch.ones(height * width, dtype=dtype, device=device)])
