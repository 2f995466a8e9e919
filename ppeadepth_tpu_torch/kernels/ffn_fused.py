"""Fused deploy ConvFFN: operand folding and kernel B.

Counterparts in the JAX package (kernels/ffn_mxu.py):
  * `fold_ffn_params`: `fold_ffn_params` (:155), run once when a session
    is built instead of inside every forward;
  * `ffn_fused` (wrapper of csrc/ffn_fused.cu): `ffn_block_apply` (:201).

`ffn_fused_plain` is the plain version: the same folded math with torch
matmuls and erf-GELU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import launch_counts
from .build import check, library

MAX_C = 1024
# the kernel's rows per block and hidden chunk width (BM, HC in
# csrc/ffn_fused.cu)
_ROWS_PER_BLOCK = 32
_HIDDEN_CHUNK = 64


class FoldedFFN(NamedTuple):
    """Kernel-B operands: weights [in, out] in the compute dtype, biases f32.
    The adapter fields are None for a ConvFFN without adapter."""

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    a1: Optional[torch.Tensor] = None
    ab1: Optional[torch.Tensor] = None
    a2: Optional[torch.Tensor] = None
    ab2: Optional[torch.Tensor] = None


def fold_ffn_params(sd, g_ffn: float = 1.0, eps: float = 1e-5,
                    dtype: torch.dtype = torch.bfloat16) -> FoldedFFN:
    """Fold preffn_bn + pw1/pw2 ConvBN (+ mlp_adapter) of one ConvFFN into
    kernel operands, in f32 math.

    sd: the ConvFFN's own state (torch names without the module prefix:
    `preffn_bn.*`, `pw1.conv.weight`, `pw1.bn.*`, `pw2.*`,
    `mlp_adapter.D_fc{1,2}.*`)."""
    f32 = {k: v.detach().to(torch.float32) for k, v in sd.items()}

    def bn_affine(pre):
        s = f32[pre + ".weight"] * torch.rsqrt(f32[pre + ".running_var"] + eps)
        return s, f32[pre + ".bias"] - f32[pre + ".running_mean"] * s

    s0, t0 = bn_affine("preffn_bn")
    W1 = f32["pw1.conv.weight"][:, :, 0, 0].t()  # [C, 4C]
    s1, t1 = bn_affine("pw1.bn")
    W1s = W1 * s1[None, :]
    W1f = W1s * s0[:, None]
    b1f = t0 @ W1s + t1
    W2 = f32["pw2.conv.weight"][:, :, 0, 0].t()  # [4C, C]
    s2, t2 = bn_affine("pw2.bn")
    W2f = W2 * s2[None, :]

    def w(t):
        return t.to(dtype).contiguous()

    if "mlp_adapter.D_fc1.weight" not in f32:
        return FoldedFFN(w(W1f), b1f.contiguous(), w(W2f), t2.contiguous())
    A1 = f32["mlp_adapter.D_fc1.weight"].t()  # [C, CA]
    A2 = f32["mlp_adapter.D_fc2.weight"].t()  # [CA, C]
    A1f = A1 * s0[:, None]
    a1f = t0 @ A1 + f32["mlp_adapter.D_fc1.bias"]
    return FoldedFFN(w(W1f), b1f.contiguous(), w(W2f), t2.contiguous(),
                     w(A1f), a1f.contiguous(), w(A2 * g_ffn),
                     (f32["mlp_adapter.D_fc2.bias"] * g_ffn).contiguous())


def ffn_fused_plain(x2d, p: FoldedFFN):
    """Plain version of kernel B on rows x2d [M, C]: products in the operand
    dtype, biases and GELU in f32, the hidden rounded to the operand dtype
    as the kernel does."""
    h = F.gelu((x2d @ p.w1).float() + p.b1).to(p.w1.dtype)
    y = (h @ p.w2).float() + p.b2
    if p.a1 is not None:
        ah = F.gelu((x2d @ p.a1).float() + p.ab1).to(p.a1.dtype)
        y = y + (ah @ p.a2).float() + p.ab2
    return (x2d.float() + y).to(x2d.dtype)


def hidden_splits(M: int, H4: int, sms: int):
    """(splits, chunks per split) of the hidden width for kernel B: enough
    blocks for about two per SM when M alone gives fewer, each split at
    least one 64-wide hidden chunk."""
    blocks = -(-M // _ROWS_PER_BLOCK)
    chunks = -(-H4 // _HIDDEN_CHUNK)
    want = max(1, min(chunks, -(-2 * sms // blocks)))
    per_split = -(-chunks // want)
    return -(-chunks // per_split), per_split


def _validate(x, p: FoldedFFN):
    if x.dim() != 4:
        raise ValueError(f"ffn_fused: x must be [B, C, H, W], got {tuple(x.shape)}")
    B, C, H, W = x.shape
    H4 = p.w1.shape[1] if p.w1.dim() == 2 else -1
    shapes = {"w1": (C, H4), "b1": (H4,), "w2": (H4, C), "b2": (C,)}
    adapter = (p.a1, p.ab1, p.a2, p.ab2)
    if any(t is None for t in adapter) != all(t is None for t in adapter):
        raise ValueError("ffn_fused: adapter operands must be all set or all None")
    if p.a1 is not None:
        CA = p.a1.shape[1] if p.a1.dim() == 2 else -1
        shapes.update(a1=(C, CA), ab1=(CA,), a2=(CA, C), ab2=(C,))
    allowed = ((torch.bfloat16,) if x.is_cuda
               else (torch.bfloat16, torch.float32))
    if x.dtype not in allowed:
        raise TypeError(f"ffn_fused: x is {x.dtype}; expected one of {allowed}")
    for name, shape in shapes.items():
        t = getattr(p, name)
        if tuple(t.shape) != shape:
            raise ValueError(f"ffn_fused: {name} must be {shape}, got {tuple(t.shape)}")
        want = torch.float32 if name.startswith(("b", "ab")) else x.dtype
        if t.dtype != want:
            raise TypeError(f"ffn_fused: {name} is {t.dtype}, expected {want}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"ffn_fused: {name} must be a contiguous tensor "
                             f"on {x.device}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("ffn_fused: x must be channels_last contiguous")
    return B, C, H, W


def ffn_fused(x, p: FoldedFFN):
    """Deploy ConvFFN on x [B, C, H, W] channels_last: the residual
    `x + FFN(x) [+ adapter(x)]` with the BN-folded operands `p`.

    CPU tensors take `ffn_fused_plain`; CUDA tensors (bf16 only) launch
    csrc/ffn_fused.cu."""
    B, C, H, W = _validate(x, p)
    x2d = x.permute(0, 2, 3, 1).reshape(B * H * W, C)  # a view: NHWC bytes
    if not x.is_cuda:
        return ffn_fused_plain(x2d, p).reshape(B, H, W, C).permute(0, 3, 1, 2)
    ops = [t for t in p if t is not None]
    if C % 16 or C > MAX_C or any(s % 16 for t in ops for s in t.shape[:2]
                                  if t.dim() == 2):
        raise ValueError(f"ffn_fused: kernel needs C, 4C and C/4 multiples of "
                         f"16 and C <= {MAX_C}; got C={C}")
    if any(t.data_ptr() % 32 for t in (x, *ops)):
        raise ValueError("ffn_fused: operands must be 32-byte aligned")
    M, H4 = B * H * W, p.w1.shape[1]
    splits, per_split = hidden_splits(
        M, H4, torch.cuda.get_device_properties(x.device).multi_processor_count)
    out = torch.empty((B, H, W, C), dtype=x.dtype, device=x.device)
    part = (torch.empty((splits, M, C), dtype=torch.float32, device=x.device)
            if splits > 1 else None)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    err = library().ppea_ffn_fused_bf16(
        x.data_ptr(), out.data_ptr(), ptr(p.w1), ptr(p.b1), ptr(p.w2),
        ptr(p.b2), ptr(p.a1), ptr(p.ab1), ptr(p.a2), ptr(p.ab2), ptr(part),
        M, C, H4, p.a1.shape[1] if p.a1 is not None else 0, splits, per_split,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "ppea_ffn_fused_bf16")
    launch_counts["ffn_fused"] += 1
    return out.permute(0, 3, 1, 2)
