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
  stage 2 (--dc): decoders trainable iff the name holds 'adpt' or
                  'adapter'; dec_id 5 and 6 keep the encoders' 'adapter'
                  parameters only in the last block pair(s) of each stage
                  (repdepth.py:52-63);
  --fullft_reb or no --adapter: everything trainable; --dec_only and
  --lps2 freeze both encoders; --freeze_teacher_and_pose and --freeze_pose
  freeze the teacher and pose nets, or the pose nets.

The JAX package matches dec_id 5/6's blocks by whole path components
(stages_2/blocks_35); the port matches the same whole dotted components
(stages.2.blocks.35), so blocks.3 does not also take blocks.30-39.
"""

from __future__ import annotations

from typing import Dict

import torch.nn as nn

TRAIN = "trainable"
FROZEN = "frozen"
_ENCODERS = ("encoder", "mono_encoder")
_DECODERS = ("depth", "mono_depth")

# the last (RepLK, FFN) block pair of each stage for dec_id 5, and the last
# two pairs for dec_id 6 (JAX freeze.py `_DEC5_KEEP`, `_DEC6_KEEP`; the
# block lists hold 2 * layers entries): (stage, block) indices
_DEC5_KEEP = {(0, 3), (1, 3), (2, 35), (3, 3)}
_DEC6_KEEP = _DEC5_KEEP | {(0, 2), (1, 2), (2, 34), (3, 2)}


def _stage_blocks(name: str):
    """The (stage, block) pairs that `name` passes through, read from
    whole dotted components `stages.<s>.blocks.<b>`."""
    parts = name.split(".")
    return {(int(parts[i + 1]), int(parts[i + 3]))
            for i in range(len(parts) - 3)
            if parts[i] == "stages" and parts[i + 2] == "blocks"}


def _encoder_label(name: str, opt, is_student: bool) -> str:
    predicates = ("adpt", "adapter", "bn") + (("reduce",) if is_student else ())
    if not any(p in name for p in predicates):
        return FROZEN
    if opt.dc and opt.dec_id in (5, 6) and "adapter" in name:
        keep = _DEC5_KEEP if opt.dec_id == 5 else _DEC6_KEEP
        if not _stage_blocks(name) & keep:
            return FROZEN
    return TRAIN


def param_labels(model: nn.Module, opt) -> Dict[str, str]:
    """{parameter name: "trainable" | "frozen"} for a RepDepth."""
    labels = {}
    for name, _ in model.named_parameters():
        top = name.split(".")[0]
        if not opt.adapter or opt.fullft_reb:
            label = TRAIN
        elif top in _ENCODERS:
            label = _encoder_label(name, opt, is_student=top == "encoder")
        elif top in _DECODERS and opt.dc:
            label = TRAIN if "adpt" in name or "adapter" in name else FROZEN
        else:  # stage-1 decoders, pose_encoder, pose
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


def print_num_param(model: nn.Module, labels: Dict[str, str]) -> Dict:
    """Per-submodule trainable and total parameter counts, printed as the
    JAX `freeze.print_num_param` prints them (repdepth.py:511-526);
    returns {submodule: (trainable, total)}."""
    mods = {}
    for name, p in model.named_parameters():
        top = name.split(".")[0]
        t, n = mods.get(top, (0, 0))
        mods[top] = (t + (p.numel() if labels[name] == TRAIN else 0),
                     n + p.numel())
    for mod, (t, n) in sorted(mods.items()):
        print(f"for {mod} ", t, n)
    return mods
