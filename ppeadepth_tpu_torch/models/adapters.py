"""PEA adapters (JAX counterpart: models/adapters.py).

Every adapter's last projection `D_fc2` starts at zero, so a fresh adapter
model is exactly the plain backbone (replknet_adapter.py:482-508);
`models.repdepth.init_weights` applies that rule. The stage-2 decoder
adapters (`ChannelAdapter` with another output width, `UpAdapter`)
compute in float32 under any compute dtype, as the JAX modules carry no
dtype; `models.depth_decoder` turns autocast off around them.
"""

from __future__ import annotations

from typing import Optional

import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import upsample2x_nearest
from .blocks import channel_linear


class ChannelAdapter(nn.Module):
    """Bottleneck MLP over channels: Linear(C -> hidden) - GELU -
    Linear(-> C_out), hidden = int((C + C_out) / 2 * ratio), which is
    int(C * ratio) for C_out = C (the default). The ConvFFN `mlp_adapter`
    (replknet_adapter.py:20-47) and, with C_out the decoder's width, the
    stage-2 decoder adapter (JAX `DecoderAdapter`, depth_decoder_v2.py:
    19-55)."""

    def __init__(self, channels: int, mlp_ratio: float = 0.25,
                 out_channels: Optional[int] = None):
        super().__init__()
        out_channels = out_channels or channels
        hidden = int((channels + out_channels) / 2 * mlp_ratio)
        self.D_fc1 = nn.Linear(channels, hidden)
        self.D_fc2 = nn.Linear(hidden, out_channels)

    def forward(self, x):
        h = F.gelu(channel_linear(self.D_fc1, x))
        return channel_linear(self.D_fc2, h)


class BAdapter(nn.Module):
    """Block adapter, shipped variant adpt_test=4 (replknet_adapter.py:
    49-109): zero-padded Conv3x3(C -> C*ratio) - GELU - Linear(-> C)."""

    def __init__(self, channels: int, adpt_test: int = 4,
                 mlp_ratio: float = 0.25):
        super().__init__()
        if adpt_test != 4:
            raise NotImplementedError(
                f"BAdapter adpt_test={adpt_test}: only the shipped variant 4 "
                "is ported")
        hidden = int(channels * mlp_ratio)
        self.D_fc1 = nn.Conv2d(channels, hidden, 3, padding=1)
        self.D_fc2 = nn.Linear(hidden, channels)

    def forward(self, x):
        return channel_linear(self.D_fc2, F.gelu(self.D_fc1(x)))


class UpAdapter(nn.Module):
    """The dec_id-10 per-level adapter (depth_decoder_v2.py:56-79):
    Linear(C_in -> C_out), GELU, nearest 2x upsample. Its only projection,
    `D_fc1`, starts at zero (`zero_init`, read by
    `models.repdepth.init_weights`)."""

    def __init__(self, channels_in: int, channels_out: int):
        super().__init__()
        self.D_fc1 = nn.Linear(channels_in, channels_out)
        self.D_fc1.zero_init = True

    def forward(self, x):
        return upsample2x_nearest(F.gelu(channel_linear(self.D_fc1, x)))
