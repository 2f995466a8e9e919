"""Plane-sweep diff volume of one lookup frame: kernel C and its plain
version.

Counterparts in the JAX package:
  * `plane_sweep` (wrapper of csrc/plane_sweep.cu): kernels/cost_volume_mxu.py
    `frame_diffs_batch`, the TPU kernel of the student's cost volume;
  * `plane_sweep_plain`: ops/cost_volume.py `_frame_diffs` (vmapped), the
    exact f32 path the kernel is held to.

Layout: features are [B, C, H, W] tensors in torch.channels_last memory
(NHWC bytes); the kernel's output is [B, D, H, W] with D innermost in
memory (channels_last), the layout the student's concat with the current
features wants.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import launch_counts
from .build import check, library

MAX_C = 256
_FEATURE_DTYPES = (torch.float32, torch.bfloat16)
_GROUPS = (4, 8, 16)


class SweepPlan(NamedTuple):
    """Kernel C's launch: groups of `g` lanes, `nv` 16-byte vectors of
    channels a lane (blocks of 2 x 2 pixels, fixed in the kernel)."""

    g: int
    nv: int


def sweep_plan(C, dtype):
    """The launch for C channels of `dtype`: the (g, nv) whose g * nv
    vectors cover C with the fewest idle lanes, then nv nearest 2 (16
    channels a lane in bf16, 8 in f32), then the fewest lanes."""
    nvec = C * (2 if dtype == torch.bfloat16 else 4) // 16
    g, nv = min(((g, -(-nvec // g)) for g in _GROUPS if -(-nvec // g) <= 4),
                key=lambda p: (p[0] * p[1] - nvec, abs(p[1] - 2), p[0]))
    return SweepPlan(g, nv)


def plane_sweep_plain(cur, lk, A, t, bins):
    """Plain version of kernel C: `ops.cost_volume.frame_diffs` on the f32
    upcast of the features (exact from bf16). Returns [B, D, H, W] f32."""
    from ..ops.cost_volume import frame_diffs  # ops.cost_volume imports this module

    return frame_diffs(cur.permute(0, 2, 3, 1).float(),
                       lk.permute(0, 2, 3, 1).float(), A, t, bins)


def _validate(cur, lk, A, t, bins):
    if cur.dim() != 4 or lk.shape != cur.shape:
        raise ValueError(f"plane_sweep: cur and lk must be the same [B, C, H, W], "
                         f"got {tuple(cur.shape)} and {tuple(lk.shape)}")
    B, C, H, W = cur.shape
    if bins.dim() != 1 or bins.shape[0] < 1:
        raise ValueError(f"plane_sweep: bins must be [D], got {tuple(bins.shape)}")
    if A.shape != (B, 3, 3) or t.shape != (B, 3):
        raise ValueError(f"plane_sweep: A must be [{B}, 3, 3] and t [{B}, 3], "
                         f"got {tuple(A.shape)} and {tuple(t.shape)}")
    if cur.dtype not in _FEATURE_DTYPES or lk.dtype != cur.dtype:
        raise TypeError(f"plane_sweep: cur and lk are {cur.dtype}, {lk.dtype}; "
                        f"expected one of {_FEATURE_DTYPES}, both the same")
    for name, v in (("lk", lk), ("A", A), ("t", t), ("bins", bins)):
        if v.device != cur.device:
            raise ValueError(f"plane_sweep: {name} on {v.device}, cur on {cur.device}")
        if name != "lk" and (v.dtype != torch.float32 or not v.is_contiguous()):
            raise TypeError(f"plane_sweep: {name} must be contiguous float32")
    for name, v in (("cur", cur), ("lk", lk)):
        if not v.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"plane_sweep: {name} must be channels_last contiguous")
    return B, C, H, W, bins.shape[0]


def plane_sweep(cur, lk, A, t, bins):
    """Edge-masked L1 diff volume of one lookup frame for the whole batch.

    cur, lk: [B, C, H, W] channels_last, f32 or bf16 (computed in f32);
    A: [B, 3, 3], t: [B, 3], bins: [D], all f32. Returns [B, D, H, W] f32:
    for bin d and pixel (gx, gy), the mean over C of |bilinear(lk, x, y) -
    cur| at `(x, y) = proj((A @ (gx, gy, 1)) * bins[d] + t)`, zero outside
    the 2-px edge and border masks.

    CPU tensors take `plane_sweep_plain`; CUDA tensors launch
    csrc/plane_sweep.cu (C a multiple of 8, at most 256)."""
    B, C, H, W, D = _validate(cur, lk, A, t, bins)
    if not cur.is_cuda:
        return plane_sweep_plain(cur, lk, A, t, bins)
    if C % 8 or C > MAX_C:
        raise ValueError(f"plane_sweep: kernel needs C a multiple of 8 and "
                         f"<= {MAX_C}; got C={C}")
    if cur.data_ptr() % 16 or lk.data_ptr() % 16:
        raise ValueError("plane_sweep: cur and lk must be 16-byte aligned")
    return _launch(cur, lk, A, t, bins, sweep_plan(C, cur.dtype))


def _launch(cur, lk, A, t, bins, plan, fixed=False):
    """Kernel C under `plan` on validated CUDA tensors; `fixed` launches
    the diagnostic instance that points every gather at one corner (for
    timing only: its output is meaningless)."""
    B, C, H, W = cur.shape
    D = bins.shape[0]
    out = torch.empty((B, H, W, D), dtype=torch.float32, device=cur.device)
    entry = "ppea_plane_sweep_fixed" if fixed else "ppea_plane_sweep"
    err = getattr(library(), entry)(
        cur.data_ptr(), lk.data_ptr(), A.data_ptr(), t.data_ptr(),
        bins.data_ptr(), out.data_ptr(), B, H, W, C, D,
        int(cur.dtype == torch.bfloat16), *plan,
        torch.cuda.current_stream(cur.device).cuda_stream)
    check(err, entry)
    launch_counts["plane_sweep"] += 1
    return out.permute(0, 3, 1, 2)
