"""Fused deploy ConvFFN: operand folding and packing, and kernel B.

Counterparts in the JAX package (kernels/ffn_mxu.py):
  * `fold_ffn_params`: `fold_ffn_params` (:155), run once when a session
    is built instead of inside every forward;
  * `ffn_fused` (wrapper of csrc/ffn_fused.cu): `ffn_block_apply` (:201).

`pack_ffn` folds the adapter into the main products (one FFN of hidden
width 4C plus the adapter's width, C/4, or C/2 under adpt_test 2,
zero-padded to the kernel's K tile) and stores the weights
K-major, once per session (`models.replknet.ConvFFN.fold`). The kernel is
two launches of one tensor-core GEMM, up (bias, erf-GELU, bf16 hidden in
a workspace) and down (bias, residual); `ffn_plan` picks each launch's
output tile.

`ffn_fused_plain` (on the folded operands) and `ffn_packed_plain` (on the
packed ones) are the plain versions: the same math with torch matmuls and
erf-GELU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import launch_counts
from .build import check, library

# what csrc/ffn_fused.cu takes: C a multiple of K_TILE up to MAX_C (the
# widest ConvFFN of models.replknet.REPLK_CONFIGS, rep_size xl); its K tile,
# to which the packed hidden width is padded; its output tiles (BM, BN), by
# the index the C entry takes
MAX_C = 2048
K_TILE = 64
TILES = ((128, 128), (128, 64), (64, 128), (64, 64))


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


class PackedFFN(NamedTuple):
    """Kernel-B operands of `pack_ffn`: w_up [Hp, C] and w_down [C, Hp]
    K-major (a row per output column) in the compute dtype, b_up [Hp] and
    b_down [C] f32. Hp is 4C (+ the adapter's width: C/4, C/2 under
    adpt_test 2) rounded up to K_TILE; the padding is zero."""

    w_up: torch.Tensor
    b_up: torch.Tensor
    w_down: torch.Tensor
    b_down: torch.Tensor


def pack_ffn(p: FoldedFFN) -> PackedFFN:
    """One FFN from the main and adapter branches of `p`: W_up = [W1 | A1],
    b_up = [b1 | a1], W_down = [W2 ; A2], b_down = b2 + a2, the hidden
    zero-padded to a multiple of K_TILE (gelu(0) = 0)."""
    adapter = p.a1 is not None
    C = p.w1.shape[0]
    hid = p.w1.shape[1] + (p.a1.shape[1] if adapter else 0)
    pad = -hid % K_TILE

    def cat(parts, dim):
        return torch.cat([t for t in parts if t is not None], dim)

    zw = p.w1.new_zeros
    zb = p.b1.new_zeros
    w_up = cat((p.w1, p.a1, zw(C, pad)), 1)
    w_down = cat((p.w2, p.a2, zw(pad, C)), 0)
    return PackedFFN(w_up.t().contiguous(), cat((p.b1, p.ab1, zb(pad)), 0),
                     w_down.t().contiguous(),
                     (p.b2 + p.ab2) if adapter else p.b2.clone())


def ffn_packed_plain(x2d, p: PackedFFN):
    """Plain version of kernel B on the packed operands: products in the
    operand dtype, bias and GELU in f32, the hidden rounded to the operand
    dtype as the kernel's workspace holds it."""
    h = F.gelu((x2d @ p.w_up.t()).float() + p.b_up).to(p.w_up.dtype)
    y = (h @ p.w_down.t()).float() + p.b_down
    return (x2d.float() + y).to(x2d.dtype)


def _tile_blocks(M: int, N: int, tile: int) -> int:
    bm, bn = TILES[tile]
    return -(-M // bm) * (N // bn)


def gemm_plan(M: int, N: int, sms: int) -> int:
    """Output tile (index into TILES) of one product with M rows and N
    columns: the largest whose BN divides N and whose grid has at least
    `sms` blocks, else the one with the most blocks."""
    fits = [i for i, (_, bn) in enumerate(TILES) if N % bn == 0]
    if not fits:
        raise ValueError(f"ffn_fused: {N} columns is not a multiple of "
                         f"{K_TILE}")
    for i in fits:
        if _tile_blocks(M, N, i) >= sms:
            return i
    return max(fits, key=lambda i: _tile_blocks(M, N, i))


def ffn_plan(M: int, C: int, Hp: int, sms: int):
    """(tile of the up product [M, Hp], tile of the down product [M, C])."""
    return gemm_plan(M, Hp, sms), gemm_plan(M, C, sms)


def _check(x, p, shapes):
    """Shape, dtype, device and layout checks of x and the operands named
    in `shapes` (biases f32, the rest in x's dtype)."""
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


def _shape(x):
    if x.dim() != 4:
        raise ValueError(f"ffn_fused: x must be [B, C, H, W], got {tuple(x.shape)}")
    return x.shape


def _validate_folded(x, p: FoldedFFN):
    B, C, H, W = _shape(x)
    H4 = p.w1.shape[1] if p.w1.dim() == 2 else -1
    shapes = {"w1": (C, H4), "b1": (H4,), "w2": (H4, C), "b2": (C,)}
    adapter = (p.a1, p.ab1, p.a2, p.ab2)
    if any(t is None for t in adapter) != all(t is None for t in adapter):
        raise ValueError("ffn_fused: adapter operands must be all set or all None")
    if p.a1 is not None:
        CA = p.a1.shape[1] if p.a1.dim() == 2 else -1
        shapes.update(a1=(C, CA), ab1=(CA,), a2=(CA, C), ab2=(C,))
    _check(x, p, shapes)
    return B, C, H, W


def _validate_packed(x, p: PackedFFN):
    B, C, H, W = _shape(x)
    Hp = p.w_up.shape[0] if p.w_up.dim() == 2 else -1
    _check(x, p, {"w_up": (Hp, C), "b_up": (Hp,), "w_down": (C, Hp),
                  "b_down": (C,)})
    return B, C, H, W


def ffn_fused(x, p):
    """Deploy ConvFFN on x [B, C, H, W] channels_last: the residual
    `x + FFN(x) [+ adapter(x)]` with the operands `p`, a `PackedFFN` (what
    `ConvFFN.fold` stores) or a `FoldedFFN` (packed per call, for tests).

    CPU tensors take the plain version of `p`'s form; CUDA tensors (bf16
    only, C a multiple of K_TILE up to MAX_C) launch csrc/ffn_fused.cu."""
    if isinstance(p, FoldedFFN):
        B, C, H, W = _validate_folded(x, p)
        if not x.is_cuda:
            x2d = x.permute(0, 2, 3, 1).reshape(B * H * W, C)  # NHWC bytes
            return ffn_fused_plain(x2d, p).reshape(B, H, W, C).permute(0, 3, 1, 2)
        p = pack_ffn(p)
    B, C, H, W = _validate_packed(x, p)
    x2d = x.permute(0, 2, 3, 1).reshape(B * H * W, C)  # a view: NHWC bytes
    if not x.is_cuda:
        return ffn_packed_plain(x2d, p).reshape(B, H, W, C).permute(0, 3, 1, 2)
    M, Hp = B * H * W, p.w_up.shape[0]
    if C % K_TILE or C > MAX_C or Hp % K_TILE:
        raise ValueError(f"ffn_fused: kernel needs C and the packed hidden "
                         f"multiples of {K_TILE}, C <= {MAX_C}; got C={C}, "
                         f"Hp={Hp}")
    if any(t.data_ptr() % 16 for t in (x, *p)):
        raise ValueError("ffn_fused: operands must be 16-byte aligned")
    tile_up, tile_down = ffn_plan(
        M, C, Hp,
        torch.cuda.get_device_properties(x.device).multi_processor_count)
    hidden = torch.empty((M, Hp), dtype=x.dtype, device=x.device)
    out = torch.empty((B, H, W, C), dtype=x.dtype, device=x.device)
    err = library().ppea_ffn_fused_bf16(
        x.data_ptr(), p.w_up.data_ptr(), p.b_up.data_ptr(),
        p.w_down.data_ptr(), p.b_down.data_ptr(), hidden.data_ptr(),
        out.data_ptr(), M, C, Hp, tile_up, tile_down,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "ppea_ffn_fused_bf16")
    launch_counts["ffn_fused"] += 1
    return out.permute(0, 3, 1, 2)
