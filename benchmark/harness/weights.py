"""Seeded weights of the whole network in training form, made on the
device, and the BN calibration pass.

Conv and linear weights are LeCun-normal, drawn in one call; the
adapters' last projections (`D_fc2`, and stage 2's `deconv_adpt`) are
drawn small but not zero, so every adapter does work and trains; the
last BN scale of each residual branch is drawn small, as in trained
residual nets. The BN running statistics are then calibrated by one
train-mode pass of each network over the cell's own kind of images (a
random 36-block net with arbitrary statistics grows its activations
about 1000x, and bf16 against f32 then measures chaos), and perturbed so
that folding BN is exercised with non-trivial values.

The same state_dict goes to the measured program and to the reference.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from reference import nets
from . import traffic

CALIB_IMAGES = 4


@torch.no_grad()
def state_dict(cfg: dict, seed: int, device) -> dict:
    """The whole network's state_dict (reference names), on `device`."""
    gen = torch.Generator(device).manual_seed(seed)
    with torch.device(device):
        model = nets.RepDepth(cfg)
    convs = [(n, m) for n, m in model.named_modules()
             if isinstance(m, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d,
                               nets.DepthwiseConv))]
    flat = torch.randn(sum(m.weight.numel() for _, m in convs),
                       generator=gen, device=device)
    off = 0
    for name, m in convs:
        w = m.weight
        n = w.numel()
        small = name.endswith("D_fc2") or name.endswith("deconv_adpt")
        scale = 0.05 if small else 1.0 / math.sqrt(math.prod(w.shape[1:]))
        w.copy_(flat[off:off + n].view_as(w) * scale)
        off += n
        if getattr(m, "bias", None) is not None:
            m.bias.zero_()
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    for m in bns:
        m.reset_parameters()
        m.momentum = None  # one pass: running statistics = batch statistics
    for name, p in model.named_parameters():
        if name.endswith("pw2.bn.weight"):
            p.copy_(torch.rand(p.shape, generator=gen, device=device) * 0.05 + 0.05)

    o = cfg["options"]
    H, W = o["height"], o["width"]
    frames = traffic.frames(gen, CALIB_IMAGES, H, W, (2, 5), device)
    cur, lookup = frames[0].permute(0, 3, 1, 2), frames[-1].permute(0, 3, 1, 2)
    K, invK = traffic.intrinsics(CALIB_IMAGES, H // 4, W // 4, device)
    rates = {}
    for m in model.modules():
        if isinstance(m, nets.DropPath):
            rates[m], m.rate = m.rate, 0.0
    model.train()
    with nets.tf32_off():
        model.forward_mono(cur)
        T = model.pose_pair(lookup, cur, invert=True)[2]
        model.forward_multi(cur, lookup[:, None], T[:, None], K, invK, 0.1, 10.0)
    model.eval()
    for m, r in rates.items():
        m.rate = r
    for m in bns:
        m.momentum = 0.1
        std = m.running_var.sqrt()
        m.running_mean += torch.randn(std.shape, generator=gen, device=device) * 0.05 * std
        m.running_var *= torch.rand(std.shape, generator=gen, device=device) * 0.4 + 0.8
    return {k: v.detach() for k, v in model.state_dict().items()}
