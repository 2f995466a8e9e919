"""RepDepth, the teacher/student composition for serving (JAX counterpart:
models/repdepth.py).

Submodule names define the checkpoint namespace, as in the reference
(repdepth.py:19-624): `encoder` (RepLKMatching student encoder with the
cost volume), `depth` (student DepthDecoderV2), `mono_encoder` (RepLKNet
teacher encoder), `mono_depth` (teacher DepthDecoderV2), `pose_encoder`
(ResNet-18 over two stacked frames) and `pose` (PoseDecoder). The training
`__call__`, the chained matching poses of `predict_poses` and matching
augmentation come with the training slices of the port.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..core.geometry import transformation_from_parameters
from .blocks import DepthwiseConv
from .depth_decoder import DepthDecoderV2
from .matching_encoder import RepLKMatching
from .pose import PoseDecoder
from .replknet import RepLKNet, num_ch_enc
from .resnet import ResnetEncoder

# modules that always compute in float32: the JAX pose nets carry no dtype
_F32_MODULES = ("pose_encoder", "pose")


def _cudnn_without_tf32():
    """cuDNN's flags as they are, but TF32 off: the f32 pose net must not
    round its conv inputs to TF32, torch's default for cuDNN convs."""
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=c.benchmark,
                   benchmark_limit=c.benchmark_limit,
                   deterministic=c.deterministic, allow_tf32=False)


class RepDepth(nn.Module):
    """opt: `ppeadepth_tpu.options.Config`, or any object with its fields
    adapter, adpt_test, rep_size, g_blk, g_ffn, ratio, trans, input,
    mono_trans, mono_input, dc, dyn_cv, num_depth_bins and depth_binning
    (the port itself imports nothing of the JAX package)."""

    def __init__(self, opt, merged: bool = False):
        super().__init__()
        if opt.dyn_cv:
            raise NotImplementedError(
                "the DynamicDepth cost volume (--dyn_cv) is not ported yet")
        adpt = opt.adpt_test if opt.adapter else -1
        common = dict(rep_size=opt.rep_size, adpt_test=adpt, g_blk=opt.g_blk,
                      g_ffn=opt.g_ffn, ratio=opt.ratio, merged=merged)
        ch = num_ch_enc(opt.rep_size)
        self.encoder = RepLKMatching(
            trans_adpt=opt.trans, input_adpt=opt.input,
            num_depth_bins=opt.num_depth_bins,
            depth_binning=opt.depth_binning, **common)
        self.depth = DepthDecoderV2(ch, dc=opt.dc)
        self.mono_encoder = RepLKNet(trans_adpt=opt.mono_trans,
                                     input_adpt=opt.mono_input, **common)
        self.mono_depth = DepthDecoderV2(ch, dc=opt.dc)
        self.pose_encoder = ResnetEncoder(18, num_input_images=2)
        self.pose = PoseDecoder(self.pose_encoder.num_ch_enc,
                                num_frames_to_predict_for=2)

    def fold_ffn(self, dtype: torch.dtype) -> None:
        """Fold every ConvFFN of both encoders into kernel-B operands."""
        self.mono_encoder.fold_ffn(dtype)
        self.encoder.replk.fold_ffn(dtype)

    def forward_mono(self, image):
        """Teacher single-frame path: image [B, 3, H, W] ->
        {("disp", 0): [B, 1, H, W]} (trainer.py:751, evaluate_depth.py:167)."""
        return self.mono_depth(self.mono_encoder(image))

    def pose_pair(self, a, b, invert: bool = False):
        """Pose from a temporally ordered image pair [B, 3, H, W] each, in
        float32 with TF32 off (JAX `_pose_pair`, without remat). Returns
        (axisangle, translation [B, 2, 1, 3], T [B, 4, 4])."""
        with _cudnn_without_tf32():
            feats = self.pose_encoder(torch.cat([a, b], 1).float())
            axisangle, translation = self.pose(feats)
        T = transformation_from_parameters(axisangle[:, 0, 0],
                                           translation[:, 0, 0], invert=invert)
        return axisangle, translation, T

    def forward_multi(self, image, lookup_frames, rel_poses, K2, invK2,
                      min_depth_bin, max_depth_bin):
        """Student multi-frame path: image [B, 3, H, W], lookup_frames
        [B, F, 3, H, W], rel_poses [B, F, 4, 4], K2/invK2 [B, 4, 4] at 1/4
        scale -> ({("disp", 0): [B, 1, H, W]}, lowest_cost, confidence)."""
        features, lowest_cost, conf = self.encoder(
            image, lookup_frames, rel_poses, K2, invK2, min_depth_bin,
            max_depth_bin)
        return self.depth(features), lowest_cost, conf


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init: LeCun-normal conv/linear weights (flax's
    default), zero biases, identity BN, and zero adapter `D_fc2` weights
    (replknet_adapter.py:482-508). Draws on the CPU from `generator`."""
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear, DepthwiseConv)):
            w = m.weight
            fan_in = math.prod(w.shape[1:])
            if name.endswith("D_fc2"):
                w.zero_()
            else:
                w.copy_(torch.randn(w.shape, generator=generator)
                        / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


def cast_compute(model: nn.Module, dtype: torch.dtype) -> None:
    """Cast conv and linear weights to the compute dtype, as the JAX modules
    cast params at use. BatchNorm keeps f32 statistics (its output follows
    the input dtype), the disparity heads stay f32 (depth_decoder.py:76) and
    so do the pose nets (`_F32_MODULES`). Folded ConvFFN operands are left
    as folded."""
    for name, m in model.named_modules():
        if (isinstance(m, (nn.Conv2d, nn.Linear, DepthwiseConv))
                and ".disp_convs." not in name
                and name.split(".")[0] not in _F32_MODULES):
            m.to(dtype)
