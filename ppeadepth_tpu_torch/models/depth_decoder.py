"""DepthDecoderV2 with the stage-2 decoder adapters (JAX counterpart:
models/depth_decoder.py; reference depth_decoder_v2.py:83-245).

Five up-stages (the first four take encoder skips feats[2-i], the fifth
none), nearest 2x upsampling, reflection-padded ConvBlocks, and one
Conv3x3 + sigmoid disparity head at full resolution that always computes in
float32 (autocast off), as the JAX head does (depth_decoder.py:76).

Stage 2 (`dc`) adds a decoder adapter whose input depends on `dec_id`.
Design 1, the shipped one, takes concat(feats[0], nearest-8x(feats[3])),
and a zero-initialised ConvTranspose (`deconv_adpt`) carries its output
into the decoder's tail. dec_id 10 adds one `UpAdapter` per level
(`adapters`). Every adapter starts at zero, so a stage-2 model starts at its
stage-1 behaviour (repdepth.py:175-262). The adapters compute in float32
(autocast off), as the JAX modules carry no dtype; their sum with the
trunk is float32 and goes on to the head.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..ops.resize import resize_nearest, upsample2x_nearest
from .adapters import ChannelAdapter, UpAdapter
from .blocks import Conv3x3, ConvBlock

# the stage-2 designs of the JAX decoder (depth_decoder.py:54-149)
_ADAPTER_DESIGNS = (1, 2, 3, 4, 5, 6, 7, 8, 10)


def conv_transpose_3x3s2(channels: int) -> nn.ConvTranspose2d:
    """torch ConvTranspose2d(k=3, s=2, p=1, output_padding=1), the JAX
    `ConvTranspose3x3s2`; zero-initialised by `models.repdepth.init_weights`
    (both `deconv_adpt` uses are, repdepth.py:246-250)."""
    return nn.ConvTranspose2d(channels, channels, 3, stride=2, padding=1,
                              output_padding=1)


def _f32(fn, *xs):
    """fn of xs in float32 with autocast off."""
    with torch.autocast(xs[0].device.type, enabled=False):
        return fn(*(x.float() for x in xs))


class DepthDecoderV2(nn.Module):
    def __init__(self, num_ch_enc: Sequence[int],
                 num_output_channels: int = 1, dc: bool = False,
                 dec_id: int = 1, dec_ratio: float = 0.25):
        super().__init__()
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

        self.dc, self.dec_id = dc, dec_id
        if not dc:
            return
        if dec_id not in _ADAPTER_DESIGNS:
            raise ValueError(f"unknown dec_id {dec_id}; one of {_ADAPTER_DESIGNS}")
        if dec_id == 10:
            ins = [ch[3]] + [ch[4 - i] // 2 for i in range(1, 4)]
            outs = [ch[2 - i] for i in range(3)] + [ch[0] // 2]
            self.adapters = nn.ModuleList(
                [UpAdapter(i, o) for i, o in zip(ins, outs)])
            return
        adapter_in = {2: ch[0] + ch[3] + ch[2] + ch[1], 3: ch[3]}.get(
            dec_id, ch[0] + ch[3])
        ratio = dec_ratio if dec_id in (1, 5, 6, 7) else 0.25
        self.adapter = ChannelAdapter(adapter_in, ratio, out_channels=base_ch)
        if dec_id != 8:
            self.deconv_adpt = conv_transpose_3x3s2(base_ch)
        if dec_id == 4:
            self.deconv_adpt2 = conv_transpose_3x3s2(base_ch)

    def _adapter_out(self, feats):
        """The decoder adapter's output at half resolution (dec_id 1-8)."""
        x = feats[-1]
        x_up = resize_nearest(x, 8 * x.shape[2], 8 * x.shape[3])
        if self.dec_id == 3:
            ins = (x_up,)
        elif self.dec_id == 2:
            f2, f1 = feats[-2], feats[1]
            ins = (feats[0], x_up,
                   resize_nearest(f2, 4 * f2.shape[2], 4 * f2.shape[3]),
                   resize_nearest(f1, 2 * f1.shape[2], 2 * f1.shape[3]))
        else:
            ins = (feats[0], x_up)

        def run(*xs):
            a = self.adapter(torch.cat(xs, 1) if len(xs) > 1 else xs[0])
            if self.dec_id == 8:
                return upsample2x_nearest(a)
            return self.deconv_adpt(a)

        return _f32(run, *ins)

    def forward(self, input_features):
        x = input_features[-1]
        up_adapters = self.dc and self.dec_id == 10
        adpt_out = None
        if self.dc and not up_adapters:
            adpt_out = self._adapter_out(input_features)
        for i in range(4):
            if up_adapters:
                adpt_out = _f32(self.adapters[i], x)
            x = upsample2x_nearest(self.upconvs_0[i](x))
            if i < 3:
                x = torch.cat([x, input_features[2 - i]], 1)
            x = self.upconvs_1[i](x)
            if up_adapters:
                x = x + 0.01 * adpt_out
        x = upsample2x_nearest(self.upconvs_0[4](x))
        x = self.upconvs_1[4](x)
        if adpt_out is not None and not up_adapters:
            if self.dec_id == 4:
                x = x + _f32(self.deconv_adpt2, adpt_out)
            else:
                x = x + upsample2x_nearest(adpt_out)
        head = self.disp_convs[0]
        with torch.autocast(x.device.type, enabled=False):
            disp = torch.sigmoid(head(x.to(head.conv.weight.dtype)))
        return {("disp", 0): disp}
