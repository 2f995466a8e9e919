"""RepLKNet-31B/L/XL large-kernel backbone with PEA adapters
(JAX counterpart: models/replknet.py; reference replknet.py:205-398 and
replknet_adapter.py:381-644).

  stem: conv3x3 s2 -> dw3x3 -> conv1x1 -> dw3x3 s2            (1/4 res)
        [+ input adapter on the first conv's output]
  4 stages of num_blocks x (RepLKBlock, ConvFFN) pairs
  transitions: conv1x1 + dw3x3 s2 between stages
        [+ drop-path(transition adapter) on each transition's output]

The transition and input adapters (`trans_adpt`, `input_adpt`) run in
float32 with autocast off, as their JAX modules carry no dtype; their sum
with the compute-dtype stream is taken in f32 and rounded back to the
stream's dtype, which kernels A and B take (JAX keeps that sum in f32).

Training form: per-block drop-path on the linear schedule
`np.linspace(0, rate, sum(layers))` (block pair i of the network takes
entry i, replknet.py:239), BN in train mode, and with `use_checkpoint` each
block recomputed in the backward pass by `torch.utils.checkpoint` (the
JAX `nn.remat`, replknet.py:197-203). The merged (deploy) form holds one
biased large-kernel conv per block (`lkb_reparam`, kernel A); after
`RepLKNet.fold_ffn` every ConvFFN runs as kernel B on operands folded once.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.ffn_fused import PackedFFN, ffn_fused, fold_ffn_params, pack_ffn
from .adapters import BAdapter, ChannelAdapter, InputAdapter
from .blocks import ConvBN, DepthwiseConv, DropPath

REPLK_CONFIGS = {
    "b": dict(
        large_kernel_sizes=(31, 29, 27, 13),
        layers=(2, 2, 18, 2),
        channels=(128, 256, 512, 1024),
        small_kernel=5,
        dw_ratio=1.0,
    ),
    "l": dict(
        large_kernel_sizes=(31, 29, 27, 13),
        layers=(2, 2, 18, 2),
        channels=(192, 384, 768, 1536),
        small_kernel=5,
        dw_ratio=1.0,
    ),
    "xl": dict(
        large_kernel_sizes=(27, 27, 27, 13),
        layers=(2, 2, 18, 2),
        channels=(256, 512, 1024, 2048),
        small_kernel=None,
        dw_ratio=1.5,
    ),
    # tiny config for tests (not in the reference)
    "t": dict(
        large_kernel_sizes=(7, 7, 5, 3),
        layers=(1, 1, 2, 1),
        channels=(16, 32, 64, 128),
        small_kernel=3,
        dw_ratio=1.0,
    ),
}


def num_ch_enc(rep_size: str):
    """Encoder widths per pyramid level (Config.num_ch_enc without jax)."""
    return tuple(REPLK_CONFIGS[rep_size]["channels"])


class ReparamLKConv(nn.Module):
    """Training form: large dw conv+BN parallel to a small dw conv+BN,
    summed. Merged form: one biased dw conv whose weights come from
    `kernels.lk_conv.merge_reparam_kernels`. Reference replknet.py:79-130.
    Both forms run their convs through kernel A."""

    def __init__(self, channels: int, kernel_size: int,
                 small_kernel: Optional[int], merged: bool = False):
        super().__init__()
        self.merged = merged
        if merged:
            self.lkb_reparam = DepthwiseConv(channels, kernel_size, bias=True,
                                             kernel_a=True)
            return
        self.lkb_origin = ConvBN(channels, channels, kernel_size,
                                 groups=channels, kernel_a=True)
        self.small_conv = None
        if small_kernel is not None:
            self.small_conv = ConvBN(channels, channels, small_kernel,
                                     groups=channels, kernel_a=True)

    def forward(self, x):
        if self.merged:
            return self.lkb_reparam(x)
        out = self.lkb_origin(x)
        if self.small_conv is not None:
            out = out + self.small_conv(x)
        return out


class RepLKBlock(nn.Module):
    def __init__(self, channels: int, dw_channels: int, lk_size: int,
                 small_kernel: Optional[int], adpt_test: int = -1,
                 g_blk: float = 1.0, ratio: float = 0.25,
                 merged: bool = False, drop_path: float = 0.0):
        super().__init__()
        self.prelkb_bn = nn.BatchNorm2d(channels, eps=1e-5)
        self.adapter = (BAdapter(channels, adpt_test, ratio)
                        if adpt_test >= 0 else None)
        self.pw1 = ConvBN(channels, dw_channels, 1, relu=True)
        self.large_kernel = ReparamLKConv(dw_channels, lk_size, small_kernel,
                                          merged)
        self.pw2 = ConvBN(dw_channels, channels, 1)
        self.drop_path = DropPath(drop_path)
        self.g_blk = g_blk

    def forward(self, x, drop_mask=None):
        out = self.prelkb_bn(x)
        adpt = self.adapter(out) if self.adapter is not None else None
        out = self.pw2(F.relu(self.large_kernel(self.pw1(out))))
        res = x + self.drop_path(out, drop_mask)
        if adpt is not None:
            res = res + self.g_blk * adpt
        return res


_FOLDED = PackedFFN._fields


class ConvFFN(nn.Module):
    """preffn_bn -> 1x1 -> erf-GELU -> 1x1, residual, plus
    `g_ffn * ChannelAdapter(preffn_bn(x))` (replknet_adapter.py:264-289).

    `fold()` stores the BN-folded kernel-B operands, packed (the adapter
    folded into the main products), as non-persistent buffers (state_dict
    keeps the reference's names); from then on the block runs as
    `kernels.ffn_fused.ffn_fused`."""

    def __init__(self, channels: int, internal_channels: int,
                 adpt_test: int = -1, g_ffn: float = 1.0,
                 drop_path: float = 0.0):
        super().__init__()
        self.preffn_bn = nn.BatchNorm2d(channels, eps=1e-5)
        self.mlp_adapter = None
        if adpt_test >= 0:
            # ConvFFN hardcodes its adapter ratio (0.5 only for adpt_test
            # 2), replknet_adapter.py:273-276
            self.mlp_adapter = ChannelAdapter(
                channels, 0.5 if adpt_test == 2 else 0.25)
        self.pw1 = ConvBN(channels, internal_channels, 1)
        self.pw2 = ConvBN(internal_channels, channels, 1)
        self.drop_path = DropPath(drop_path)
        self.g_ffn = g_ffn
        for name in _FOLDED:
            self.register_buffer("folded_" + name, None, persistent=False)

    @torch.no_grad()
    def fold(self, dtype: torch.dtype) -> None:
        p = pack_ffn(fold_ffn_params(self.state_dict(), self.g_ffn,
                                     dtype=dtype))
        for name, t in p._asdict().items():
            setattr(self, "folded_" + name, t)

    def forward(self, x, drop_mask=None):
        if self.folded_w_up is not None:
            return ffn_fused(x, PackedFFN(
                *(getattr(self, "folded_" + n) for n in _FOLDED)))
        out = self.preffn_bn(x)
        adpt = self.mlp_adapter(out) if self.mlp_adapter is not None else None
        out = self.pw2(F.gelu(self.pw1(out)))
        res = x + self.drop_path(out, drop_mask)
        if adpt is not None:
            res = res + self.g_ffn * adpt
        return res


def _route_adpt(adpt_test: int):
    """adpt_test 5/6 routing (replknet_adapter.py:341-347):
    returns (replk_block_adpt, convffn_adpt)."""
    if adpt_test == 5:
        return -1, 1
    if adpt_test == 6:
        return 4, -1
    return adpt_test, adpt_test


@contextlib.contextmanager
def _running_stats_held(module: nn.Module):
    """Momentum 0 for every BN of `module` inside the block, and its batch
    counter restored after: a recompute under activation checkpointing
    leaves the running statistics as the first forward set them, as flax's
    remat discards the recompute's updates."""
    bns = [m for m in module.modules() if isinstance(m, nn.BatchNorm2d)]
    saved = [(m.momentum, m.num_batches_tracked.clone()) for m in bns]
    for m in bns:
        m.momentum = 0.0
    try:
        yield
    finally:
        for m, (mom, count) in zip(bns, saved):
            m.momentum = mom
            m.num_batches_tracked.copy_(count)


class RepLKNetStage(nn.Module):
    def __init__(self, channels: int, num_blocks: int, lk_size: int,
                 small_kernel: Optional[int], dw_ratio: float = 1.0,
                 ffn_ratio: float = 4.0, adpt_test: int = -1,
                 g_blk: float = 1.0, g_ffn: float = 1.0, ratio: float = 0.25,
                 merged: bool = False, drop_paths: Sequence[float] = (),
                 use_checkpoint: bool = False):
        super().__init__()
        adpt_r, adpt_c = _route_adpt(adpt_test)
        drop_paths = list(drop_paths) or [0.0] * num_blocks
        blocks = []
        for i in range(num_blocks):
            blocks.append(RepLKBlock(
                channels, int(channels * dw_ratio), lk_size, small_kernel,
                adpt_test=adpt_r, g_blk=g_blk, ratio=ratio, merged=merged,
                drop_path=drop_paths[i]))
            blocks.append(ConvFFN(channels, int(channels * ffn_ratio),
                                  adpt_test=adpt_c, g_ffn=g_ffn,
                                  drop_path=drop_paths[i]))
        self.blocks = nn.ModuleList(blocks)
        self.use_checkpoint = use_checkpoint

    def forward(self, x, generator=None):
        """`generator` draws the drop-path masks (None: torch's default
        generator); each is drawn before its block, outside the
        checkpointed function."""
        for blk in self.blocks:
            mask = blk.drop_path.draw(x, generator)
            if self.use_checkpoint and torch.is_grad_enabled():
                x = checkpoint(blk, x, mask, use_reentrant=False,
                               context_fn=lambda blk=blk: (
                                   contextlib.nullcontext(),
                                   _running_stats_held(blk)))
            else:
                x = blk(x, mask)
        return x


def _transition(in_ch: int, out_ch: int) -> nn.Sequential:
    """1x1 conv-bn-relu to the next width + dw 3x3 s2 conv-bn-relu
    (replknet.py:250-254)."""
    return nn.Sequential(
        ConvBN(in_ch, out_ch, 1, relu=True),
        ConvBN(out_ch, out_ch, 3, stride=2, groups=out_ch, relu=True),
    )


class RepLKNet(nn.Module):
    """Feature-pyramid RepLKNet (out_indices mode; the reference's
    classification head is never used by PPEA-Depth)."""

    def __init__(self, rep_size: str = "b", ffn_ratio: float = 4.0,
                 in_channels: int = 3, adpt_test: int = -1,
                 g_blk: float = 1.0, g_ffn: float = 1.0, ratio: float = 0.25,
                 trans_adpt: bool = False, input_adpt: bool = False,
                 merged: bool = False, drop_path_rate: float = 0.0,
                 use_checkpoint: bool = False, lk_backend: str = "lax"):
        super().__init__()
        if lk_backend not in ("lax", "pallas"):
            raise ValueError(f"unknown lk_backend {lk_backend!r}")
        cfg = REPLK_CONFIGS[rep_size]
        channels = cfg["channels"]
        layers = cfg["layers"]
        base = channels[0]
        self.stem = nn.ModuleList([
            ConvBN(in_channels, base, 3, stride=2, relu=True),
            # under "pallas" the one stride-1 depthwise conv outside the
            # blocks joins kernel A, as in the JAX package
            ConvBN(base, base, 3, groups=base, relu=True,
                   kernel_a=lk_backend == "pallas"),
            ConvBN(base, base, 1, relu=True),
            ConvBN(base, base, 3, stride=2, groups=base, relu=True),
        ])
        dpr = np.linspace(0.0, drop_path_rate, sum(layers)).tolist()
        self.stages = nn.ModuleList([
            RepLKNetStage(
                channels[i], layers[i], cfg["large_kernel_sizes"][i],
                cfg["small_kernel"], dw_ratio=cfg["dw_ratio"],
                ffn_ratio=ffn_ratio, adpt_test=adpt_test, g_blk=g_blk,
                g_ffn=g_ffn, ratio=ratio, merged=merged,
                drop_paths=dpr[sum(layers[:i]):sum(layers[:i + 1])],
                use_checkpoint=use_checkpoint)
            for i in range(4)
        ])
        self.transitions = nn.ModuleList([
            _transition(channels[i], channels[i + 1]) for i in range(3)
        ])
        # the transition after stage i takes the drop-path rate of the
        # stage's first block pair (JAX replknet.py:400-407)
        self.trans_adapters = self.trans_drop_paths = None
        if trans_adpt:
            self.trans_adapters = nn.ModuleList([
                ChannelAdapter(channels[i + 1], zero_init=False)
                for i in range(3)])
            self.trans_drop_paths = nn.ModuleList([
                DropPath(dpr[sum(layers[:i])]) for i in range(3)])
        self.input_adapter = InputAdapter(base) if input_adpt else None

    def fold_ffn(self, dtype: torch.dtype) -> None:
        """Fold every ConvFFN into kernel-B operands of `dtype`."""
        for m in self.modules():
            if isinstance(m, ConvFFN):
                m.fold(dtype)

    # composable pieces: the matching encoder re-enters mid-network. The
    # JAX `apply_norm` between them is the identity (norm_intermediate is
    # False wherever the network is used), so it has no counterpart here.

    def forward_stem(self, x):
        """[B, 3, H, W] -> stem features at 1/4 resolution, in the compute
        dtype and channels_last memory (the layout kernels A and B take)."""
        x = x.to(dtype=self.stem[0].conv.weight.dtype,
                 memory_format=torch.channels_last)
        x = self.stem[0](x)
        adpt = None
        if self.input_adapter is not None:
            adpt = _in_f32(self.input_adapter, x)
        for layer in self.stem[1:]:
            x = layer(x)
        return x if adpt is None else (x.float() + adpt).to(x.dtype)

    def forward_stage(self, idx: int, x, generator=None):
        return self.stages[idx](x, generator)

    def forward_transition(self, idx: int, x, generator=None):
        """Transition `idx` (and its adapter); `generator` draws the
        adapter's drop-path mask in training."""
        x = self.transitions[idx](x)
        if self.trans_adapters is None:
            return x
        drop = self.trans_drop_paths[idx]
        mask = drop.draw(x, generator)
        adpt = drop(_in_f32(self.trans_adapters[idx], x), mask)
        return (x.float() + adpt).to(x.dtype)

    def forward(self, x, generator=None):
        """[B, 3, H, W] -> the 4-level pyramid [1/4, 1/8, 1/16, 1/32].
        `generator` draws the drop-path masks in training."""
        x = self.forward_stem(x)
        feats = []
        for i in range(4):
            x = self.forward_stage(i, x, generator)
            feats.append(x)
            if i < 3:
                x = self.forward_transition(i, x, generator)
        return feats


def _in_f32(module: nn.Module, x):
    """`module` on x in float32 with autocast off."""
    with torch.autocast(x.device.type, enabled=False):
        return module(x.float())
