"""DepthDecoderV2 without stage-2 adapters (JAX counterpart:
models/depth_decoder.py; reference depth_decoder_v2.py:83-245).

Five up-stages (the first four take encoder skips feats[2-i], the fifth
none), nearest 2x upsampling, reflection-padded ConvBlocks, and one
Conv3x3 + sigmoid disparity head at full resolution that always computes in
float32 (autocast off), as the JAX head does (depth_decoder.py:76).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..ops.resize import upsample2x_nearest
from .blocks import Conv3x3, ConvBlock


class DepthDecoderV2(nn.Module):
    def __init__(self, num_ch_enc: Sequence[int],
                 num_output_channels: int = 1, dc: bool = False):
        super().__init__()
        if dc:
            raise NotImplementedError(
                "stage-2 decoder adapters (--dc) are not ported yet")
        ch = list(num_ch_enc)
        base_ch = ch[0] // 4
        up0, up1 = [], []
        x_ch = ch[3]
        for i in range(3, -1, -1):
            out = ch[i] // 2
            up0.append(ConvBlock(x_ch, out))
            skip = ch[i - 1] if i > 0 else 0
            up1.append(ConvBlock(out + skip, out))
            x_ch = out
        up0.append(ConvBlock(x_ch, base_ch))
        up1.append(ConvBlock(base_ch, base_ch))
        self.upconvs_0 = nn.ModuleList(up0)
        self.upconvs_1 = nn.ModuleList(up1)
        self.disp_convs = nn.ModuleList([Conv3x3(base_ch, num_output_channels)])

    def forward(self, input_features):
        x = input_features[-1]
        for i in range(4):
            x = upsample2x_nearest(self.upconvs_0[i](x))
            if i < 3:
                x = torch.cat([x, input_features[2 - i]], 1)
            x = self.upconvs_1[i](x)
        x = upsample2x_nearest(self.upconvs_0[4](x))
        x = self.upconvs_1[4](x)
        head = self.disp_convs[0]
        with torch.autocast(x.device.type, enabled=False):
            disp = torch.sigmoid(head(x.to(head.conv.weight.dtype)))
        return {("disp", 0): disp}
