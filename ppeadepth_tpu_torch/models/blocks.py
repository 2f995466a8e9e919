"""Shared conv building blocks (JAX counterpart: models/blocks.py).

conv_bn / conv_bn_relu mirror replknet.py:51-66; Conv3x3/ConvBlock mirror
layers.py:103-135 (reflection padding + ELU). BatchNorm is plain
`nn.BatchNorm2d(eps=1e-5)`: torch's semantics are the reference the JAX
`models/norm.BatchNorm` reproduces. DropPath is the identity at inference
and is not a module here.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.lk_conv import lk_depthwise


class DepthwiseConv(nn.Module):
    """Depthwise conv with SAME padding; weight [C, 1, k, k].

    `large=True` marks the large-kernel convs of ReparamLKConv: they run
    through kernel A (`kernels.lk_conv.lk_depthwise`, stride 1 only). The
    small depthwise convs of the stem and transitions stay `F.conv2d`, as
    the JAX package leaves them to XLA."""

    def __init__(self, channels: int, kernel_size: int, stride: int = 1,
                 bias: bool = False, large: bool = False):
        super().__init__()
        if large and stride != 1:
            raise ValueError("large-kernel depthwise conv is stride 1 only")
        self.stride = stride
        self.large = large
        self.weight = nn.Parameter(
            torch.empty(channels, 1, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(channels)) if bias else None

    def forward(self, x):
        if self.large:
            return lk_depthwise(x, self.weight, self.bias)
        k = self.weight.shape[-1]
        return F.conv2d(x, self.weight, self.bias, stride=self.stride,
                        padding=k // 2, groups=x.shape[1])


class ConvBN(nn.Module):
    """conv (bias-free) + BN [+ ReLU]; depthwise when groups == channels."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, groups: int = 1, relu: bool = False,
                 large: bool = False):
        super().__init__()
        if groups == out_ch == in_ch:
            self.conv = DepthwiseConv(out_ch, kernel_size, stride, large=large)
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
