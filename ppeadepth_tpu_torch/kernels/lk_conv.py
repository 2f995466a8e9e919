"""Large-kernel depthwise conv: BN folding, kernel merging, and kernel A.

Counterparts in the JAX package:
  * `fuse_conv_bn`, `merge_reparam_kernels`: kernels/lk_conv.py:73-107;
  * `depthwise_plain`: kernels/lk_conv.py `_depthwise_lax`;
  * `lk_depthwise` (wrapper of csrc/lk_dwconv.cu): kernels/banded_conv.py
    `banded_depthwise`, the TPU kernel of the merged deploy convs;
  * `lk_depthwise_train`: kernels/banded_conv.py `banded_depthwise_train`
    (:152, custom VJP :169-188), the differentiable training conv: forward
    and d/dx are kernel A (d/dx on the spatially flipped kernel), d/dw is
    torch's conv weight gradient, as JAX takes the lax pullback for it.

Layout: activations are NCHW tensors in torch.channels_last memory (NHWC
bytes), weights torch's depthwise [C, 1, k, k].
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import launch_counts
from .build import check, library

MAX_K = 31


def fuse_conv_bn(kernel, gamma, beta, mean, var, eps: float = 1e-5):
    """Fold eval-mode BN into a bias-free conv: returns (kernel', bias').
    kernel: [O, I, kh, kw] (torch layout). replknet.py:68-77."""
    std = torch.sqrt(var + eps)
    t = gamma / std
    return kernel * t[:, None, None, None], beta - mean * gamma / std


def merge_reparam_kernels(lk_kernel, lk_bn, small_kernel=None, small_bn=None,
                          eps: float = 1e-5):
    """Merge the parallel (large, small) depthwise conv+BN branches into one
    biased large-kernel conv. BNs are dicts with torch's names
    {weight, bias, running_mean, running_var}. replknet.py:110-117."""
    def fold(k, bn):
        return fuse_conv_bn(k, bn["weight"], bn["bias"], bn["running_mean"],
                            bn["running_var"], eps)

    eq_k, eq_b = fold(lk_kernel, lk_bn)
    if small_kernel is not None:
        s_k, s_b = fold(small_kernel, small_bn)
        pad = (lk_kernel.shape[-1] - small_kernel.shape[-1]) // 2
        eq_k = eq_k + F.pad(s_k, (pad, pad, pad, pad))
        eq_b = eq_b + s_b
    return eq_k, eq_b


def depthwise_plain(x, w, b: Optional[torch.Tensor] = None):
    """SAME stride-1 depthwise conv, the plain version of kernel A."""
    return F.conv2d(x, w, b, padding=w.shape[-1] // 2, groups=x.shape[1])


def _validate(x, w, b):
    if x.dim() != 4:
        raise ValueError(f"lk_depthwise: x must be [B, C, H, W], got {tuple(x.shape)}")
    B, C, H, W = x.shape
    k = w.shape[-1] if w.dim() == 4 else -1
    if w.shape != (C, 1, k, k) or k % 2 == 0 or not 1 <= k <= MAX_K:
        raise ValueError(f"lk_depthwise: w must be [C={C}, 1, k, k] with odd "
                         f"k <= {MAX_K}, got {tuple(w.shape)}")
    if b is not None and b.shape != (C,):
        raise ValueError(f"lk_depthwise: bias must be [{C}], got {tuple(b.shape)}")
    allowed = (torch.bfloat16, torch.float32)
    for name, t in (("x", x), ("w", w), ("bias", b)):
        if t is None:
            continue
        if t.dtype != x.dtype or t.dtype not in allowed:
            raise TypeError(f"lk_depthwise: {name} is {t.dtype}; expected "
                            f"one of {allowed}, all the same dtype")
        if t.device != x.device:
            raise ValueError(f"lk_depthwise: {name} on {t.device}, x on {x.device}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("lk_depthwise: x must be channels_last contiguous")
    if not w.is_contiguous() or (b is not None and not b.is_contiguous()):
        raise ValueError("lk_depthwise: w and bias must be contiguous")
    return B, C, H, W, k


_ENTRY = {torch.bfloat16: "ppea_lk_dwconv_bf16", torch.float32: "ppea_lk_dwconv_f32"}


def _launch(x, w, b, counter: str):
    """Kernel A on validated CUDA tensors; counts the launch under
    `counter`."""
    B, C, H, W = x.shape
    if x.data_ptr() % 16:
        raise ValueError("lk_depthwise: x must be 16-byte aligned")
    y = torch.empty((B, H, W, C), dtype=x.dtype, device=x.device)
    entry = _ENTRY[x.dtype]
    err = getattr(library(), entry)(
        x.data_ptr(), w.data_ptr(), b.data_ptr() if b is not None else None,
        y.data_ptr(), B, H, W, C, w.shape[-1],
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, entry)
    launch_counts[counter] += 1
    return y.permute(0, 3, 1, 2)


def lk_depthwise(x, w, b: Optional[torch.Tensor] = None):
    """SAME stride-1 depthwise conv `x * w (+ b)`.

    x: [B, C, H, W] channels_last; w: [C, 1, k, k] (odd k <= 31); b: [C] or
    None; all bf16 or all f32. CPU tensors take `depthwise_plain`; CUDA
    tensors launch csrc/lk_dwconv.cu."""
    _validate(x, w, b)
    if not x.is_cuda:
        return depthwise_plain(x, w, b)
    return _launch(x, w, b, "lk_dwconv")


def _input_grad(g, w):
    """d/dx of the SAME conv: the same conv of the output gradient with the
    spatially flipped kernel (banded_conv.py:173-178). Autograd's gradient
    need not be channels_last: the copy to it is part of this step."""
    g = g.contiguous(memory_format=torch.channels_last)
    wf = w.flip(-1, -2).contiguous()
    _validate(g, wf, None)
    if not g.is_cuda:
        return depthwise_plain(g, wf)
    return _launch(g, wf, None, "lk_dwconv_dx")


class _LKDepthwiseTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, w)
        return lk_depthwise(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = _input_grad(g, w) if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:
            k = w.shape[-1]
            dw = torch.nn.grad.conv2d_weight(x, w.shape, g, padding=k // 2,
                                             groups=x.shape[1])
        return dx, dw


def lk_depthwise_train(x, w):
    """Differentiable SAME stride-1 depthwise conv without bias (the
    training form's large and small kernels). Forward: `lk_depthwise`;
    d/dx: kernel A on the flipped kernel (`lk_dwconv_dx` launches on a
    card, `depthwise_plain` on the CPU); d/dw only when `w` requires grad,
    by torch's conv weight gradient. Inputs as `lk_depthwise`."""
    return _LKDepthwiseTrain.apply(x, w)
