"""Parameter freezing by name (JAX counterpart: train/freeze.py
`param_labels`; reference repdepth.py:47-66, 121-140, 404-440).

The JAX package partitions its parameter tree into trainable and frozen
leaves; the port applies the same name predicates to its parameter names
(the reference's) and sets `requires_grad`, so the optimizer sees only
the trainable set:

  student encoder: trainable iff the name holds 'adpt', 'adapter', 'bn'
                   or 'reduce';
  teacher encoder: the same without 'reduce';
  decoders and pose nets: trainable (stage 1);
  --fullft_reb or no --adapter: everything trainable; --dec_only and
  --lps2 freeze both encoders; --freeze_teacher_and_pose and --freeze_pose
  freeze the teacher and pose nets, or the pose nets.

Stage 2 (--dc, decoder adapters and `dec_id`) is not ported.
"""

from __future__ import annotations

from typing import Dict

import torch.nn as nn

TRAIN = "trainable"
FROZEN = "frozen"
_ENCODERS = ("encoder", "mono_encoder")


def _encoder_label(name: str, is_student: bool) -> str:
    predicates = ("adpt", "adapter", "bn") + (("reduce",) if is_student else ())
    return TRAIN if any(p in name for p in predicates) else FROZEN


def param_labels(model: nn.Module, opt) -> Dict[str, str]:
    """{parameter name: "trainable" | "frozen"} for a RepDepth."""
    if opt.dc:
        raise NotImplementedError("stage 2 (--dc) freezing is not ported yet")
    labels = {}
    for name, _ in model.named_parameters():
        top = name.split(".")[0]
        if not opt.adapter or opt.fullft_reb:
            label = TRAIN
        elif top in _ENCODERS:
            label = _encoder_label(name, is_student=top == "encoder")
        else:  # depth, mono_depth, pose_encoder, pose
            label = TRAIN
        if opt.adapter and not opt.fullft_reb and opt.dec_only and top in _ENCODERS:
            label = FROZEN
        if opt.lps2 and top in _ENCODERS:
            label = FROZEN
        if opt.freeze_teacher_and_pose and top in (
                "mono_encoder", "mono_depth", "pose_encoder", "pose"):
            label = FROZEN
        if opt.freeze_pose and top in ("pose_encoder", "pose"):
            label = FROZEN
        labels[name] = label
    return labels


def apply_labels(model: nn.Module, labels: Dict[str, str]) -> None:
    """requires_grad = (label == "trainable") for every parameter."""
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] == TRAIN)
