"""Camera geometry (JAX counterpart: core/geometry.py). Reference:
layers.py:14-199. Batched over a leading axis, in the JAX order of
operations; matrix products run in full f32 (TF32 off, torch's default
for matmuls)."""

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


def backproject_depth(depth, inv_K):
    """Depth [B, H, W] or [B, H, W, 1] -> homogeneous camera points
    [B, 4, H*W] (layers.py:163-168)."""
    if depth.dim() == 4:
        depth = depth[..., 0]
    B, H, W = depth.shape
    pix = pixel_grid(H, W, depth.dtype, depth.device)
    cam = torch.einsum("bij,jn->bin", inv_K[:, :3, :3], pix)
    cam = cam * depth.reshape(B, 1, H * W)
    return torch.cat([cam, torch.ones_like(cam[:, :1])], 1)


def _normalise(pix, height: int, width: int):
    """Pixel coordinates [B, 2, H*W] -> grid_sample coordinates
    [B, H, W, 2] (align_corners=True: `(x / (W - 1) - 0.5) * 2`)."""
    B = pix.shape[0]
    pix = pix.reshape(B, 2, height, width).permute(0, 2, 3, 1)
    x = (pix[..., 0] / (width - 1) - 0.5) * 2.0
    y = (pix[..., 1] / (height - 1) - 0.5) * 2.0
    return torch.stack([x, y], -1)


def project_3d(points, K, T, height: int, width: int, eps: float = 1e-7):
    """Homogeneous points [B, 4, H*W] seen by camera (K, T) -> normalised
    sample coordinates [B, H, W, 2] (layers.py:184-199)."""
    P = (K @ T)[:, :3, :]
    cam = P @ points
    pix = cam[:, :2] / (cam[:, 2:3] + eps)
    return _normalise(pix, height, width)


def reproject_coords(depth, inv_K, K, T, eps: float = 1e-7):
    """Fused backproject -> transform -> project for the inverse warp:
    depth [B, H, W] or [B, H, W, 1]; inv_K, K, T [B, 4, 4] -> normalised
    sample coordinates [B, H, W, 2]. Algebraically project_3d of
    backproject_depth, through one `A = (K T)[:3, :3] inv_K[:3, :3]` per
    item (JAX `reproject_coords`, the same order of operations)."""
    if depth.dim() == 4:
        depth = depth[..., 0]
    B, H, W = depth.shape
    pix = pixel_grid(H, W, depth.dtype, depth.device)
    P = (K @ T)[:, :3, :]
    A = P[:, :, :3] @ inv_K[:, :3, :3]
    base = torch.einsum("bij,jn->bin", A, pix)
    cam = base * depth.reshape(B, 1, H * W) + P[:, :, 3:4]
    pix2 = cam[:, :2] / (cam[:, 2:3] + eps)
    return _normalise(pix2, H, W)
