"""PEA adapters (JAX counterpart: models/adapters.py).

Every adapter's last projection `D_fc2` starts at zero, so a fresh adapter
model is exactly the plain backbone (replknet_adapter.py:482-508);
`models.repdepth.init_weights` applies that rule.
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from .blocks import channel_linear


class ChannelAdapter(nn.Module):
    """Bottleneck MLP over channels: Linear(C -> C*ratio) - GELU -
    Linear(-> C). The ConvFFN `mlp_adapter` (replknet_adapter.py:20-47)."""

    def __init__(self, channels: int, mlp_ratio: float = 0.25):
        super().__init__()
        hidden = int(channels * mlp_ratio)
        self.D_fc1 = nn.Linear(channels, hidden)
        self.D_fc2 = nn.Linear(hidden, channels)

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
