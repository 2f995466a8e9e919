"""RepDepth, the teacher/student composition (JAX counterpart:
models/repdepth.py).

Submodule names define the checkpoint namespace, as in the reference
(repdepth.py:19-624): `encoder` (RepLKMatching student encoder with the
cost volume), `depth` (student DepthDecoderV2), `mono_encoder` (RepLKNet
teacher encoder), `mono_depth` (teacher DepthDecoderV2), `pose_encoder`
(ResNet-18 over two stacked frames) and `pose` (PoseDecoder).

`forward_train` is the training forward (JAX `__call__`): the loss poses
and the chained gradient-free matching poses (`predict_poses`), matching
augmentation from given uniforms, the teacher and the student. Under a
bf16 autocast region the convs compute in bf16 on f32 parameters, as flax
casts parameters at use; the pose nets, the cost-volume geometry and the
disparity heads stay f32 (autocast off inside them).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..core.geometry import transformation_from_parameters
from ..ops.resize import resize_nearest
from ..utils.trace import span
from .blocks import DepthwiseConv
from .depth_decoder import DepthDecoderV2
from .matching_encoder import RepLKMatching
from .pose import PoseDecoder
from .replknet import RepLKNet, num_ch_enc
from .resnet import ResnetEncoder

# modules that always compute in float32: the JAX pose nets carry no dtype
_F32_MODULES = ("pose_encoder", "pose")
# decoder submodules that always compute in float32: the disparity head
# and the stage-2 adapters
_DECODERS = ("depth", "mono_depth")
_DECODER_F32 = ("disp_convs", "adapter", "adapters", "deconv_adpt",
                "deconv_adpt2")
# encoder adapters that always compute in float32: the transition and
# input adapters (their JAX modules carry no dtype)
_F32_ADAPTERS = {"trans_adapters", "input_adapter"}
# the DynamicDepth volume's options (`--dyn_cv`) and Config's defaults
_CV_DEFAULTS = dict(cv_min=False, cv_set_1=False, cv_pool=False,
                    cv_pool_radius=1, cv_pool_th=0.7)


def cudnn_without_tf32():
    """cuDNN's flags as they are, but TF32 off, and the caller's restored on
    exit: the f32 pose net and the f32 eval pass must not round their conv
    inputs to TF32, torch's default for cuDNN convs."""
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=c.benchmark,
                   benchmark_limit=c.benchmark_limit,
                   deterministic=c.deterministic, allow_tf32=False)


def matching_augmentation(u, current, lookup_frames, rel_poses):
    """repdepth.py:251-267 with the per-sample uniforms `u` [B] given:
    u < 0.25 replaces the lookup frames by the (non-augmented) current
    frame, 0.25 <= u < 0.5 zeroes the relative poses (the cost volume then
    skips those frames). current: [B, 3, H, W]; lookup_frames: [B, F, 3,
    H, W]; rel_poses: [B, F, 4, 4]. Returns (lookup_frames, rel_poses,
    augmentation_mask [B, 1, 1, 1] f32)."""
    static = u < 0.25
    zero = (u >= 0.25) & (u < 0.5)
    lookup_frames = torch.where(static[:, None, None, None, None],
                                current[:, None], lookup_frames)
    rel_poses = torch.where(zero[:, None, None, None],
                            torch.zeros_like(rel_poses), rel_poses)
    return (lookup_frames, rel_poses,
            (static | zero).to(torch.float32).reshape(-1, 1, 1, 1))


class RepDepth(nn.Module):
    """opt: `options.Config` (or the JAX package's), or any object with its
    fields adapter, adpt_test, rep_size, g_blk, g_ffn, ratio, trans,
    input, mono_trans, mono_input, dc, dyn_cv, num_depth_bins and
    depth_binning, and dec_id, dec_ratio and the `cv_*` options where the
    object has them (Config's defaults otherwise; the port imports nothing
    of the JAX package); training also reads frame_ids, matching_ids, height, width and
    no_matching_augmentation, and drop_path_rate, use_checkpoint and
    lk_backend where the object has them (Config's defaults 0.3, False and
    "lax" otherwise)."""

    def __init__(self, opt, merged: bool = False):
        super().__init__()
        adpt = opt.adpt_test if opt.adapter else -1
        common = dict(rep_size=opt.rep_size, adpt_test=adpt, g_blk=opt.g_blk,
                      g_ffn=opt.g_ffn, ratio=opt.ratio, merged=merged,
                      drop_path_rate=getattr(opt, "drop_path_rate", 0.3),
                      use_checkpoint=getattr(opt, "use_checkpoint", False),
                      lk_backend=getattr(opt, "lk_backend", "lax"))
        self.opt = opt
        ch = num_ch_enc(opt.rep_size)
        self.encoder = RepLKMatching(
            trans_adpt=opt.trans, input_adpt=opt.input,
            num_depth_bins=opt.num_depth_bins,
            depth_binning=opt.depth_binning, **common)
        dec = dict(dc=opt.dc, dec_id=getattr(opt, "dec_id", 1),
                   dec_ratio=getattr(opt, "dec_ratio", 0.25))
        self.depth = DepthDecoderV2(ch, **dec)
        self.mono_encoder = RepLKNet(trans_adpt=opt.mono_trans,
                                     input_adpt=opt.mono_input, **common)
        self.mono_depth = DepthDecoderV2(ch, **dec)
        self.pose_encoder = ResnetEncoder(18, num_input_images=2)
        self.pose = PoseDecoder(self.pose_encoder.num_ch_enc,
                                num_frames_to_predict_for=2)

    def fold_ffn(self, dtype: torch.dtype) -> None:
        """Fold every ConvFFN of both encoders into kernel-B operands."""
        self.mono_encoder.fold_ffn(dtype)
        self.encoder.replk.fold_ffn(dtype)

    def forward_mono(self, image, generator=None):
        """Teacher single-frame path: image [B, 3, H, W] ->
        {("disp", 0): [B, 1, H, W]} (trainer.py:751, evaluate_depth.py:167).
        `generator` draws the drop-path masks in training."""
        with span("model.teacher_encoder"):
            features = self.mono_encoder(image, generator)
        with span("model.decoder"):
            return self.mono_depth(features)

    def pose_pair(self, a, b, invert: bool = False):
        """Pose from a temporally ordered image pair [B, 3, H, W] each, in
        float32 with TF32 off and autocast off (JAX `_pose_pair`, without
        remat). Returns (axisangle, translation [B, 2, 1, 3], T [B, 4, 4])."""
        with (span("model.pose"), cudnn_without_tf32(),
              torch.autocast(a.device.type, enabled=False)):
            feats = self.pose_encoder(torch.cat([a, b], 1).float())
            axisangle, translation = self.pose(feats)
            T = transformation_from_parameters(
                axisangle[:, 0, 0], translation[:, 0, 0], invert=invert)
        return axisangle, translation, T

    def forward_multi(self, image, lookup_frames, rel_poses, K2, invK2,
                      min_depth_bin, max_depth_bin, generator=None,
                      aug_mask=None):
        """Student multi-frame path: image [B, 3, H, W], lookup_frames
        [B, F, 3, H, W], rel_poses [B, F, 4, 4], K2/invK2 [B, 4, 4] at 1/4
        scale -> ({("disp", 0): [B, 1, H, W]}, lowest_cost, confidence).
        Under `opt.dyn_cv` the DynamicDepth volume with the `cv_*` options
        (Config's defaults where the object lacks them); aug_mask [B, 1, 1,
        1] gates its in-fill (zeros when None)."""
        opt = self.opt
        with span("model.student_encoder"):
            features, lowest_cost, conf = self.encoder(
                image, lookup_frames, rel_poses, K2, invK2, min_depth_bin,
                max_depth_bin, generator, aug_mask=aug_mask, dyn=opt.dyn_cv,
                **{k: getattr(opt, k, v) for k, v in _CV_DEFAULTS.items()})
        with span("model.decoder"):
            return self.depth(features), lowest_cost, conf

    def predict_poses(self, inputs, stop_grad: bool = False):
        """Poses of the loss for frame_ids[1:] and the chained matching
        poses for matching_ids[1:] (repdepth.py:140-189), in the JAX order
        of pose-net calls (which orders the BN updates): the loss pairs,
        then the matching pairs. Matching poses are gradient-free and zero
        for a blank (all-zero) lookup frame. inputs: {("color_aug", f, 0):
        [B, 3, H, W]}."""
        opt = self.opt
        img = {f: inputs[("color_aug", f, 0)]
               for f in set(opt.frame_ids) | set(opt.matching_ids)}
        out = {}
        for f in opt.frame_ids[1:]:
            pair = (img[f], img[0]) if f < 0 else (img[0], img[f])
            res = self.pose_pair(*pair, invert=f < 0)
            if stop_grad:
                res = tuple(r.detach() for r in res)
            for key, r in zip(("axisangle", "translation", "cam_T_cam"), res):
                out[(key, 0, f)] = r
        rel = {}
        with torch.no_grad(), torch.autocast(img[0].device.type, enabled=False):
            for f in opt.matching_ids[1:]:
                if f < 0:
                    T = self.pose_pair(img[f], img[f + 1], invert=True)[2]
                    if f != -1:
                        T = T @ rel[f + 1]
                else:
                    T = self.pose_pair(img[f - 1], img[f])[2]
                    if f != 1:
                        T = T @ rel[f - 1]
                blank = img[f].sum(dim=(1, 2, 3)) == 0
                rel[f] = torch.where(blank[:, None, None], torch.zeros_like(T), T)
        for f, T in rel.items():
            out[("relative_pose", f)] = T
        return out

    def forward_train(self, inputs, min_depth_bin, max_depth_bin, aug_u=None,
                      *, freeze_tp: bool = False, freeze_pose: bool = False,
                      generator=None):
        """Full training forward (JAX `RepDepth.__call__` with train=True,
        repdepth.py:219-295). Every module must be in train mode.

        inputs: {("color", f, 0), ("color_aug", f, 0): [B, 3, H, W];
        ("K", 2), ("inv_K", 2): [B, 4, 4]}; min/max_depth_bin: 0-d
        tensors; aug_u: [B] uniforms of the matching augmentation (unused
        under no_matching_augmentation); generator: drop-path masks.
        Returns (mono_outputs, outputs) with the JAX keys: poses,
        ("disp", 0) [B, 1, H, W] of each branch, "augmentation_mask"
        [B, 1, 1, 1], and the student's "lowest_cost" and
        "consistency_mask" [B, H, W] at full resolution."""
        opt = self.opt
        poses = self.predict_poses(inputs, stop_grad=freeze_tp or freeze_pose)
        outputs, mono_outputs = dict(poses), dict(poses)
        ids = opt.matching_ids[1:]
        rel_poses = torch.stack([poses[("relative_pose", i)] for i in ids], 1)
        lookup = torch.stack([inputs[("color_aug", i, 0)] for i in ids], 1)
        if opt.no_matching_augmentation:
            aug_mask = torch.zeros((lookup.shape[0], 1, 1, 1),
                                   device=lookup.device)
        else:
            lookup, rel_poses, aug_mask = matching_augmentation(
                aug_u, inputs[("color", 0, 0)], lookup, rel_poses)
        outputs["augmentation_mask"] = aug_mask

        img = inputs[("color_aug", 0, 0)]
        mono = self.forward_mono(img, generator)
        if freeze_tp:
            mono = {k: v.detach() for k, v in mono.items()}
        mono_outputs.update(mono)
        outputs[("mono_disp", 0)] = mono[("disp", 0)]

        multi, lowest_cost, conf = self.forward_multi(
            img, lookup, rel_poses, inputs[("K", 2)], inputs[("inv_K", 2)],
            min_depth_bin, max_depth_bin, generator, aug_mask=aug_mask)
        outputs.update(multi)
        H, W = opt.height, opt.width
        outputs["lowest_cost"] = resize_nearest(lowest_cost[:, None], H, W)[:, 0]
        outputs["consistency_mask"] = resize_nearest(conf[:, None], H, W)[:, 0]
        return mono_outputs, outputs


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init: LeCun-normal conv/linear weights (flax's
    default), zero biases, identity BN, and zero adapter `D_fc2` weights
    (replknet_adapter.py:482-508), zero stage-2 `deconv_adpt` ConvTransposes
    and zero layers marked `zero_init` (the dec_id-10 adapters' `D_fc1`);
    a layer's `zero_init` flag, where set, decides over its name (the
    transition adapters' `D_fc2` is drawn, PARITY §2.4). Draws on the CPU
    from `generator`."""
    for name, m in model.named_modules():
        if isinstance(m, nn.ConvTranspose2d):
            m.weight.zero_()
            m.bias.zero_()
        elif isinstance(m, (nn.Conv2d, nn.Linear, DepthwiseConv)):
            w = m.weight
            fan_in = math.prod(w.shape[1:])
            if getattr(m, "zero_init", name.endswith("D_fc2")):
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
    the input dtype), the disparity heads and the stage-2 decoder adapters
    stay f32 (depth_decoder.py:76; the JAX adapters carry no dtype), and so
    do the encoders' transition and input adapters (`_F32_ADAPTERS`) and
    the pose nets (`_F32_MODULES`). Folded ConvFFN operands are left as
    folded."""
    for name, m in model.named_modules():
        parts = name.split(".")
        if (isinstance(m, (nn.Conv2d, nn.Linear, DepthwiseConv))
                and parts[0] not in _F32_MODULES
                and not (parts[0] in _DECODERS and parts[1] in _DECODER_F32)
                and not _F32_ADAPTERS & set(parts)):
            m.to(dtype)
