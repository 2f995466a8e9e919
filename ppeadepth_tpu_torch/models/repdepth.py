"""RepDepth, teacher part (JAX counterpart: models/repdepth.py).

Submodule names define the checkpoint namespace, as in the reference
(repdepth.py:19-624): `mono_encoder` (RepLKNet teacher encoder) and
`mono_depth` (teacher DepthDecoderV2). The student, pose nets and the
training `__call__` come with later slices of the port.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from .blocks import DepthwiseConv
from .depth_decoder import DepthDecoderV2
from .replknet import RepLKNet, num_ch_enc


class RepDepth(nn.Module):
    """opt: `ppeadepth_tpu.options.Config`, or any object with its fields
    adapter, adpt_test, rep_size, g_blk, g_ffn, ratio, mono_trans,
    mono_input and dc (the port itself imports nothing of the JAX
    package)."""

    def __init__(self, opt, merged: bool = False):
        super().__init__()
        adpt = opt.adpt_test if opt.adapter else -1
        self.mono_encoder = RepLKNet(
            rep_size=opt.rep_size, adpt_test=adpt, g_blk=opt.g_blk,
            g_ffn=opt.g_ffn, ratio=opt.ratio, trans_adpt=opt.mono_trans,
            input_adpt=opt.mono_input, merged=merged)
        self.mono_depth = DepthDecoderV2(num_ch_enc(opt.rep_size), dc=opt.dc)

    def forward_mono(self, image):
        """Teacher single-frame path: image [B, 3, H, W] ->
        {("disp", 0): [B, 1, H, W]} (trainer.py:751, evaluate_depth.py:167)."""
        return self.mono_depth(self.mono_encoder(image))


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
    the input dtype) and the disparity head stays f32 (depth_decoder.py:76).
    Folded ConvFFN operands are left as folded."""
    for name, m in model.named_modules():
        if (isinstance(m, (nn.Conv2d, nn.Linear, DepthwiseConv))
                and ".disp_convs." not in name):
            m.to(dtype)
