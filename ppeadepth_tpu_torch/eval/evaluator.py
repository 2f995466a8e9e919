"""Validation and evaluation (JAX counterpart: eval/evaluator.py; the
reference's Trainer.val, trainer.py:653-857, and evaluate_depth.py:66-298).

Device pass, batched, under `torch.inference_mode` on the RepDepth in
eval mode (training form, unmerged): the pose of the raw ("color")
previous frame against the current one, the student's `forward_multi`
with the depth bins, the scaled disparity of `disp_to_depth(1e-3, 80)`,
optionally the Monodepth-v1 flip pass and the teacher's disparity. The
numpy metric pass lives in eval/metrics.py. Compute is f32, or bf16
autocast on f32 parameters under `--compute_dtype bfloat16` (the pose nets
and the cost-volume geometry stay f32, as in training). f32 convolutions
on a card follow torch's cuDNN TF32 setting; callers comparing with an
f32 reference turn it off.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..core.geometry import disp_to_depth
from . import metrics

MIN_VAL = 1e-3
MAX_VAL = 80.0
_COMPUTE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_eval_step(model, opt, with_teacher: bool):
    """eval_step(batch, min_bin, max_bin) -> (scaled disparity [B, H, W]
    of the student, or [B, 2, H, W] with the flipped pass under
    `opt.post_process`; the teacher's [B, H, W] or None). `batch`: the
    loader's dict as tensors on the model's device, colours NHWC; the
    model must be in eval mode."""
    if opt.compute_dtype not in _COMPUTE:
        raise ValueError(f"compute_dtype must be one of {sorted(_COMPUTE)}")
    bf16 = opt.compute_dtype == "bfloat16"

    @torch.inference_mode()
    def eval_step(batch, min_bin, max_bin):
        def image(f):
            return batch[("color", f, 0)].float().permute(0, 3, 1, 2)

        cur, prev = image(0), image(-1)
        if opt.static_camera:
            prev = cur
        K, invK = batch[("K", 2)].float(), batch[("inv_K", 2)].float()
        with torch.autocast(cur.device.type, dtype=torch.bfloat16,
                            enabled=bf16):
            T = model.pose_pair(prev, cur, invert=True)[2]
            rel_poses = T[:, None]
            if opt.zero_cost_volume:
                rel_poses = rel_poses * 0.0
            lookup = prev[:, None]

            def student(img, lk):
                out, _, _ = model.forward_multi(img, lk, rel_poses, K, invK,
                                                min_bin, max_bin)
                return disp_to_depth(out[("disp", 0)][:, 0].float(),
                                     MIN_VAL, MAX_VAL)[0]

            pred_disp = student(cur, lookup)
            if opt.post_process:
                # Monodepth-v1 flip post-processing: the horizontal flip
                # too, blended on the host (metrics.py)
                flipped = student(cur.flip(-1), lookup.flip(-1))
                pred_disp = torch.stack([pred_disp, flipped.flip(-1)], 1)
            mono_disp = None
            if with_teacher:
                mono = model.forward_mono(cur)[("disp", 0)][:, 0].float()
                mono_disp = disp_to_depth(mono, MIN_VAL, opt.max_depth)[0]
        return pred_disp, mono_disp

    return eval_step


def load_gt_depths(opt, num: Optional[int] = None, splits_dir="./splits"):
    """GT depths per split (trainer.py:760-767): for CityScapes the first
    `num` (all when None) of `splits_dir`/cityscapes/gt_depths/NNN_depth.npy,
    else `splits_dir`/<eval_split>/gt_depths.npz."""
    if opt.eval_split == "cityscapes":
        d = os.path.join(splits_dir, opt.eval_split, "gt_depths")
        n = num if num is not None else len(os.listdir(d))
        return [np.load(os.path.join(d, str(i).zfill(3) + "_depth.npy"))
                for i in range(n)]
    gt_path = os.path.join(splits_dir, opt.eval_split, "gt_depths.npz")
    if not os.path.exists(gt_path):
        raise FileNotFoundError(
            f"{gt_path} not found — export it first with "
            f"`python -m ppeadepth_tpu.export_gt_depth --data_path <kitti> "
            f"--split {opt.eval_split}`")
    return np.load(gt_path, fix_imports=True, encoding="latin1",
                   allow_pickle=True)["data"]


def predict_disps(model, opt, val_loader, min_bin=0.1, max_bin=10.0,
                  with_teacher: bool = False, device=None):
    """The device pass over every batch of `val_loader` (stacked numpy
    dicts; the last may be partial): (student disparities [N, H, W], or
    [N, 2, H, W] under post_process; teacher disparities [N, H, W] or
    None), numpy. `device`: where the batches go (the model's device when
    None). The model runs in eval mode and gets its mode back after."""
    if device is None:
        device = next(model.parameters()).device
    step = make_eval_step(model, opt, with_teacher)
    was_training = model.training
    model.eval()
    disps, mono_disps = [], []
    try:
        for batch in val_loader:
            batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
            d, md = step(batch, min_bin, max_bin)
            disps.append(d.cpu().numpy())
            if md is not None:
                mono_disps.append(md.cpu().numpy())
    finally:
        model.train(was_training)
    return (np.concatenate(disps, 0),
            np.concatenate(mono_disps, 0) if mono_disps else None)


def run_eval(model, opt, val_loader, min_bin=0.1, max_bin=10.0,
             with_teacher: bool = False, gt_depths=None,
             splits_dir: str = "./splits", min_val: float = MIN_VAL,
             max_val: float = MAX_VAL, device=None):
    """Full evaluation: returns (mean_errors [7], teacher mean_errors [7]
    or None). `min_bin`, `max_bin`: floats or 0-d tensors on the device."""
    pred_disps, mono_disps = predict_disps(model, opt, val_loader, min_bin,
                                           max_bin, with_teacher, device)
    if opt.post_process:
        pred_disps = metrics.batch_post_process_disparity(
            pred_disps[:, 0], pred_disps[:, 1])
    if gt_depths is None:
        gt_depths = load_gt_depths(opt, pred_disps.shape[0], splits_dir)
    mean_errors, _ = metrics.evaluate_disps(
        pred_disps, gt_depths, opt.eval_split, min_val, max_val,
        opt.disable_median_scaling, opt.pred_depth_scale_factor)
    mono_errors = None
    if mono_disps is not None:
        mono_errors, _ = metrics.evaluate_disps(
            mono_disps, gt_depths, opt.eval_split, min_val, max_val,
            opt.disable_median_scaling, opt.pred_depth_scale_factor)
    return mean_errors, mono_errors
