"""ResNet-18 feature encoder of the pose net (JAX counterpart:
models/resnet.py; reference resnet_encoder.py:26-72, 367-409).

torchvision's resnet18 under the reference's names (`encoder.conv1`,
`encoder.layer1.0.downsample.0`, ...) with a `num_input_images`-wide stem
for the 2-frame pose input, input normalised (x - 0.45) / 0.225, and the
5-level pyramid [relu(bn1(conv1)), layer1 (after the 3/2/1 max-pool),
layer2, layer3, layer4]. The pose nets always compute in float32, as the
JAX modules carry no dtype.
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(out_ch, eps=1e-5)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(out_ch, eps=1e-5)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride, bias=False),
                nn.BatchNorm2d(out_ch, eps=1e-5))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class _ResNet18(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        widths = (64, 128, 256, 512)
        prev = 64
        for i, width in enumerate(widths):
            stride = 1 if i == 0 else 2
            setattr(self, f"layer{i + 1}", nn.Sequential(
                BasicBlock(prev, width, stride), BasicBlock(width, width)))
            prev = width


class ResnetEncoder(nn.Module):
    """ResNet-18 pyramid of `num_input_images` frames stacked on channels.
    The ResNet-50 (Bottleneck) variant of the JAX module is not ported."""

    num_ch_enc = (64, 64, 128, 256, 512)

    def __init__(self, num_layers: int = 18, num_input_images: int = 1):
        super().__init__()
        if num_layers != 18:
            raise NotImplementedError(
                f"ResnetEncoder({num_layers}): only ResNet-18 is ported")
        self.encoder = _ResNet18(3 * num_input_images)

    def forward(self, x):
        """x: [B, 3 * num_input_images, H, W] in [0, 1] -> 5 feature levels."""
        e = self.encoder
        x = F.relu(e.bn1(e.conv1((x - 0.45) / 0.225)))
        feats = [x]
        x = F.max_pool2d(x, 3, 2, 1)
        for layer in (e.layer1, e.layer2, e.layer3, e.layer4):
            x = layer(x)
            feats.append(x)
        return feats
