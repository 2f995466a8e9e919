"""Photometric warp of the training loss: kernel D and its plain version.

Counterparts in the JAX package:
  * `warp_border` (wrapper of csrc/warp_border.cu, forward and coordinate
    gradient): kernels/warp_mxu.py `grid_sample_border_mxu` with its
    custom VJP (:262-353), the TPU kernel of every `_warp_frames` warp;
  * `warp_border_plain`: ops/sampling.grid_sample(..., "border") on a
    stop-gradient image, the exact f32 path (the `lax` / `mxu_exact`
    semantics) the kernel is held to.

Layout: NHWC throughout, as the JAX functions: images [N, H, W, C] f32
with C <= 4, coordinates [N, Ho, Wo, 2] f32 normalised (x, y), both
contiguous. The image gets no gradient, as on the TPU path (:288).
"""

from __future__ import annotations

import torch

from ..ops.sampling import grid_sample
from . import launch_counts
from .build import check, library

MAX_C = 4


def warp_border_plain(img, coords):
    """Plain version of kernel D: border-mode bilinear sample with
    align_corners=True, differentiable in `coords` only."""
    return grid_sample(img.detach(), coords, "border")


def _validate(img, coords):
    if img.dim() != 4 or not 1 <= img.shape[-1] <= MAX_C:
        raise ValueError(f"warp_border: img must be [N, H, W, C<={MAX_C}], "
                         f"got {tuple(img.shape)}")
    if (coords.dim() != 4 or coords.shape[-1] != 2
            or coords.shape[0] != img.shape[0]):
        raise ValueError(f"warp_border: coords must be [{img.shape[0]}, Ho, Wo, 2], "
                         f"got {tuple(coords.shape)}")
    for name, t in (("img", img), ("coords", coords)):
        if t.dtype != torch.float32:
            raise TypeError(f"warp_border: {name} is {t.dtype}; expected float32")
        if t.device != img.device:
            raise ValueError(f"warp_border: coords on {t.device}, img on {img.device}")
        if not t.is_contiguous():
            raise ValueError(f"warp_border: {name} must be contiguous")


def _dims(img, coords):
    N, H, W, C = img.shape
    return N, H, W, C, coords.shape[1], coords.shape[2]


def _launch_fwd(img, coords):
    N, H, W, C, Ho, Wo = _dims(img, coords)
    out = torch.empty((N, Ho, Wo, C), dtype=img.dtype, device=img.device)
    err = library().ppea_warp_border_fwd(
        img.data_ptr(), coords.data_ptr(), out.data_ptr(), N, H, W, C, Ho, Wo,
        torch.cuda.current_stream(img.device).cuda_stream)
    check(err, "ppea_warp_border_fwd")
    launch_counts["warp_fwd"] += 1
    return out


def coords_grad(img, coords, g):
    """Kernel D's backward on CUDA tensors: the gradient [N, Ho, Wo, 2] of
    the warp with respect to `coords` for the output gradient `g` [N, Ho,
    Wo, C]; the corners are recomputed from `img` and `coords`."""
    _validate(img, coords)
    if not img.is_cuda:
        raise ValueError("coords_grad launches kernel D: CUDA tensors only")
    if g.shape != coords.shape[:3] + img.shape[-1:] or g.dtype != torch.float32:
        raise ValueError(f"warp_border: g must be f32 {tuple(coords.shape[:3])} "
                         f"+ ({img.shape[-1]},), got {g.dtype} {tuple(g.shape)}")
    g = g.contiguous()
    dcoords = torch.empty_like(coords)
    N, H, W, C, Ho, Wo = _dims(img, coords)
    err = library().ppea_warp_border_bwd(
        img.data_ptr(), coords.data_ptr(), g.data_ptr(), dcoords.data_ptr(),
        N, H, W, C, Ho, Wo, torch.cuda.current_stream(img.device).cuda_stream)
    check(err, "ppea_warp_border_bwd")
    launch_counts["warp_bwd"] += 1
    return dcoords


class _WarpBorder(torch.autograd.Function):
    """Kernel D's forward; its backward is the coordinate-gradient kernel."""

    @staticmethod
    def forward(ctx, img, coords):
        ctx.save_for_backward(img, coords)
        return _launch_fwd(img, coords)

    @staticmethod
    def backward(ctx, g):
        img, coords = ctx.saved_tensors
        return None, coords_grad(img, coords, g)


def warp_border(img, coords):
    """Border-mode bilinear warp `img` at `coords` (align_corners=True),
    differentiable in `coords` only.

    img: [N, H, W, C] f32, C <= 4; coords: [N, Ho, Wo, 2] f32 normalised
    (x, y); both contiguous. Returns [N, Ho, Wo, C] f32. CPU tensors take
    `warp_border_plain`; CUDA tensors launch csrc/warp_border.cu (forward,
    and in the backward the coordinate-gradient kernel)."""
    _validate(img, coords)
    if not img.is_cuda:
        return warp_border_plain(img, coords)
    if coords.data_ptr() % 8:
        raise ValueError("warp_border: coords must be 8-byte aligned")
    return _WarpBorder.apply(img.detach(), coords)
