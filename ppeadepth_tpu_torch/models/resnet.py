"""ResNet-18/50 feature encoder (JAX counterpart: models/resnet.py;
reference resnet_encoder.py:26-72, 367-409).

torchvision's resnet18 / resnet50 under the reference's names
(`encoder.conv1`, `encoder.layer1.0.downsample.0`, `encoder.layer1.0.conv3`
in a Bottleneck, ...) with a `num_input_images`-wide stem for the 2-frame
pose input, input normalised (x - 0.45) / 0.225, and the 5-level pyramid
[relu(bn1(conv1)), layer1 (after the 3/2/1 max-pool), layer2, layer3,
layer4]. ResNet-18 is the pose encoder; ResNet-50 is reached through the
legacy eval's teacher (`eval_depth_ori --eval_teacher --num_layers 50`).
The pose nets always compute in float32, as the JAX modules carry no
dtype.
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


class Bottleneck(nn.Module):
    """1x1 (width) - 3x3 stride s - 1x1 (4 x width), BN after each, with a
    1x1 projection of the identity where the shape changes."""

    def __init__(self, in_ch: int, width: int, stride: int = 1):
        super().__init__()
        out_ch = 4 * width
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width, eps=1e-5)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width, eps=1e-5)
        self.conv3 = nn.Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out_ch, eps=1e-5)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride, bias=False),
                nn.BatchNorm2d(out_ch, eps=1e-5))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


# blocks per layer (JAX resnet.py `_LAYERS`)
_LAYERS = {18: (2, 2, 2, 2), 50: (3, 4, 6, 3)}


class _ResNet(nn.Module):
    def __init__(self, num_layers: int, in_ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        bottleneck = num_layers > 34
        prev = 64
        for i, (width, n) in enumerate(zip((64, 128, 256, 512),
                                           _LAYERS[num_layers])):
            blocks = []
            for j in range(n):
                stride = 2 if i > 0 and j == 0 else 1
                if bottleneck:
                    blocks.append(Bottleneck(prev, width, stride))
                    prev = 4 * width
                else:
                    blocks.append(BasicBlock(prev, width, stride))
                    prev = width
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))


class ResnetEncoder(nn.Module):
    """ResNet-18 or -50 pyramid of `num_input_images` frames stacked on
    channels."""

    def __init__(self, num_layers: int = 18, num_input_images: int = 1):
        super().__init__()
        if num_layers not in _LAYERS:
            raise ValueError(f"ResnetEncoder: num_layers must be one of "
                             f"{sorted(_LAYERS)}, got {num_layers}")
        self.num_ch_enc = ((64, 256, 512, 1024, 2048) if num_layers > 34
                           else (64, 64, 128, 256, 512))
        self.encoder = _ResNet(num_layers, 3 * num_input_images)

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
