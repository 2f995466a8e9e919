"""Pose decoder and PoseCNN (JAX counterpart: models/pose.py; reference
pose_decoder.py:12-52, pose_cnn.py:10-47). `PoseCNN` is not wired into
`RepDepth`, as in the JAX package (models/repdepth.py:13-15): the
reference's `--pose_cnn` path calls an undefined `predict_poses_vit`."""

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


class PoseCNN(nn.Module):
    """Pose from `num_input_frames` frames stacked on channels [B, 3 *
    num_input_frames, H, W]: seven conv + ReLU layers (16-256 wide,
    kernels 7/5/3, strides 2 then 1) under the reference's names `net.0`
    .. `net.6`, a 1x1 `pose_conv` to 6 per lookup frame, the mean over H,
    W scaled by 0.01 -> (axisangle, translation), each [B, num_input_frames
    - 1, 1, 3]."""

    def __init__(self, num_input_frames: int = 3):
        super().__init__()
        self.num_input_frames = num_input_frames
        widths = (16, 32, 64, 128, 256, 256, 256)
        strides = (2, 2, 2, 2, 2, 1, 1)
        kernels = (7, 5, 3, 3, 3, 3, 3)
        prev = 3 * num_input_frames
        convs = []
        for w, s, k in zip(widths, strides, kernels):
            convs.append(nn.Conv2d(prev, w, k, s, k // 2))
            prev = w
        self.net = nn.ModuleList(convs)
        self.pose_conv = nn.Conv2d(prev, 6 * (num_input_frames - 1), 1)

    def forward(self, x):
        for conv in self.net:
            x = F.relu(conv(x))
        out = self.pose_conv(x).mean(dim=(2, 3))
        out = 0.01 * out.reshape(-1, self.num_input_frames - 1, 1, 6)
        return out[..., :3], out[..., 3:]
