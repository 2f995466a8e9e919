"""Shared conv building blocks (JAX counterpart: models/blocks.py).

conv_bn / conv_bn_relu mirror replknet.py:51-66; Conv3x3/ConvBlock mirror
layers.py:103-135 (reflection padding + ELU). BatchNorm is plain
`nn.BatchNorm2d(eps=1e-5)`: torch's semantics are the reference the JAX
`models/norm.BatchNorm` reproduces (unbiased running variance; flax
momentum 0.9 is torch momentum 0.1). `DropPath` is timm's per-sample
stochastic depth.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.lk_conv import lk_depthwise, lk_depthwise_train
from ..parallel import dist


class DepthwiseConv(nn.Module):
    """Depthwise conv with SAME padding; weight [C, 1, k, k].

    `kernel_a=True` runs the conv through kernel A (stride 1 only), as
    `kernels.lk_conv.lk_depthwise`, or as the differentiable
    `lk_depthwise_train` whenever autograd is recording: the depthwise
    convs of ReparamLKConv always, and the stem's stride-1 3x3 conv under
    `--lk_backend pallas`, the convs the JAX package routes to its Pallas
    kernel there (kernels/lk_conv.py `depthwise_conv2d`). The weight is
    cast to the input's dtype at the call (f32 parameters under bf16
    compute). The other depthwise convs (stride 2 in the stem and
    transitions, and the stem's 3x3 under "lax") stay `F.conv2d`, as the
    JAX package leaves them to XLA."""

    def __init__(self, channels: int, kernel_size: int, stride: int = 1,
                 bias: bool = False, kernel_a: bool = False):
        super().__init__()
        if kernel_a and stride != 1:
            raise ValueError("kernel A takes stride-1 depthwise convs only")
        self.stride = stride
        self.kernel_a = kernel_a
        self.weight = nn.Parameter(
            torch.empty(channels, 1, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(channels)) if bias else None

    def forward(self, x):
        if self.kernel_a:
            w = self.weight.to(x.dtype)
            b = None if self.bias is None else self.bias.to(x.dtype)
            if not torch.is_grad_enabled():
                return lk_depthwise(x, w, b)
            y = lk_depthwise_train(x, w)
            return y if b is None else y + b[:, None, None]
        k = self.weight.shape[-1]
        return F.conv2d(x, self.weight, self.bias, stride=self.stride,
                        padding=k // 2, groups=x.shape[1])


class ConvBN(nn.Module):
    """conv (bias-free) + BN [+ ReLU]; depthwise when groups == channels."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, groups: int = 1, relu: bool = False,
                 kernel_a: bool = False):
        super().__init__()
        if groups == out_ch == in_ch:
            self.conv = DepthwiseConv(out_ch, kernel_size, stride,
                                      kernel_a=kernel_a)
        else:
            self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride,
                                  kernel_size // 2, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-5)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class Conv3x3(nn.Module):
    """Reflection-padded 3x3 conv with bias (layers.py:119-135)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 3)

    def forward(self, x):
        return self.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"))


class ConvBlock(nn.Module):
    """Conv3x3 + ELU (layers.py:103-116)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = Conv3x3(in_ch, out_ch)

    def forward(self, x):
        return F.elu(self.conv(x))


def channel_linear(linear: nn.Linear, x):
    """Apply an nn.Linear over the channel axis of [B, C, H, W] (a dense
    layer on the last axis of the NHWC bytes; no copy for channels_last)."""
    return linear(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm semantics): in training, each
    sample's residual branch is kept with probability 1 - rate and scaled
    by 1 / (1 - rate), else zeroed. The mask is drawn by `draw` and passed
    to the forward, so a block recomputed under activation checkpointing
    reuses it."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def draw(self, x, generator=None):
        """Mask [B, 1, 1, 1] of x's dtype (1 / keep or 0), or None where
        the branch is kept whole (eval mode or rate 0). `generator` (None:
        torch's default) lies on x's device. Under data parallelism the
        mask is drawn for the global batch and this rank takes its rows
        (`parallel.dist.rank_rows`)."""
        if not self.training or self.rate == 0.0:
            return None
        keep = 1.0 - self.rate
        mask = torch.empty((x.shape[0] * dist.world(), 1, 1, 1),
                           device=x.device)
        mask = dist.rank_rows(mask.bernoulli_(keep, generator=generator))
        return (mask / keep).to(x.dtype)

    def forward(self, x, mask=None):
        return x if mask is None else x * mask
