"""Pose decoder (JAX counterpart: models/pose.py `PoseDecoder`; reference
pose_decoder.py:12-52). `PoseCNN` is not ported: the JAX composition does
not wire it either (models/repdepth.py:13-15)."""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F


class PoseDecoder(nn.Module):
    """Last pyramid level -> squeeze 1x1 256 + ReLU -> two 3x3 256 + ReLU ->
    1x1 to 6 per frame -> mean over H, W, scaled by 0.01. `net.0..3` are
    the reference's names (squeeze, pose_0, pose_1, pose_2)."""

    def __init__(self, num_ch_enc, num_frames_to_predict_for: int = 2):
        super().__init__()
        self.num_frames = num_frames_to_predict_for
        self.net = nn.ModuleList([
            nn.Conv2d(num_ch_enc[-1], 256, 1),
            nn.Conv2d(256, 256, 3, padding=1),
            nn.Conv2d(256, 256, 3, padding=1),
            nn.Conv2d(256, 6 * num_frames_to_predict_for, 1),
        ])

    def forward(self, features):
        """features: one encoder pyramid -> (axisangle, translation), each
        [B, num_frames, 1, 3]."""
        out = features[-1]
        for i, conv in enumerate(self.net):
            out = conv(out)
            if i < 3:
                out = F.relu(out)
        out = 0.01 * out.mean(dim=(2, 3)).reshape(-1, self.num_frames, 1, 6)
        return out[..., :3], out[..., 3:]

