"""PEA adapters (JAX counterpart: models/adapters.py).

Every adapter's last projection `D_fc2` starts at zero, so a fresh adapter
model is exactly the plain backbone (replknet_adapter.py:482-508);
`models.repdepth.init_weights` applies that rule. The transition adapters
are the exception (`ChannelAdapter(..., zero_init=False)`): the
reference's init loop misses them (PARITY §2.4). The transition and input
adapters compute in float32 under any compute dtype, as their JAX modules
carry no dtype (`models.replknet`). The stage-2 decoder
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
    19-55), and, with zero_init=False, the transition adapter. `zero_init`
    marks `D_fc2` for `models.repdepth.init_weights`."""

    def __init__(self, channels: int, mlp_ratio: float = 0.25,
                 out_channels: Optional[int] = None, zero_init: bool = True):
        super().__init__()
        out_channels = out_channels or channels
        hidden = int((channels + out_channels) / 2 * mlp_ratio)
        self.D_fc1 = nn.Linear(channels, hidden)
        self.D_fc2 = nn.Linear(hidden, out_channels)
        self.D_fc2.zero_init = zero_init

    def forward(self, x):
        h = F.gelu(channel_linear(self.D_fc1, x))
        return channel_linear(self.D_fc2, h)


class BAdapter(nn.Module):
    """Block adapter, its variant routed by `adpt_test`
    (replknet_adapter.py:49-109), hidden width int(C * ratio):
      1, 2:  Linear - GELU - Linear;
      4:     zero-padded Conv3x3 - GELU - Linear (the shipped variant);
      other: Conv3x3 - GELU - Conv3x3."""

    def __init__(self, channels: int, adpt_test: int = 4,
                 mlp_ratio: float = 0.25):
        super().__init__()
        hidden = int(channels * mlp_ratio)
        if adpt_test in (1, 2):
            self.D_fc1 = nn.Linear(channels, hidden)
        else:
            self.D_fc1 = nn.Conv2d(channels, hidden, 3, padding=1)
        if adpt_test in (1, 2, 4):
            self.D_fc2 = nn.Linear(hidden, channels)
        else:
            self.D_fc2 = nn.Conv2d(hidden, channels, 3, padding=1)

    def forward(self, x):
        def apply(layer, t):
            return (channel_linear(layer, t) if isinstance(layer, nn.Linear)
                    else layer(t))

        return apply(self.D_fc2, F.gelu(apply(self.D_fc1, x)))


class InputAdapter(nn.Module):
    """Stem adapter (replknet_adapter.py:134-149): Conv3x3 stride 2 (C ->
    C*ratio) - BN - GELU - Conv3x3 (-> C) - BN, on the stem's first
    output; its `D_fc2` starts at zero, as the reference's name match
    takes it."""

    def __init__(self, channels: int, mlp_ratio: float = 0.25):
        super().__init__()
        hidden = int(channels * mlp_ratio)
        self.D_fc1 = nn.Conv2d(channels, hidden, 3, stride=2, padding=1)
        self.bn1 = nn.BatchNorm2d(hidden, eps=1e-5)
        self.D_fc2 = nn.Conv2d(hidden, channels, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(channels, eps=1e-5)

    def forward(self, x):
        return self.bn2(self.D_fc2(F.gelu(self.bn1(self.D_fc1(x)))))


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
