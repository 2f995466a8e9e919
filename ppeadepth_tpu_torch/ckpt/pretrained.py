"""From-scratch bootstrap from ImageNet weights (JAX counterpart:
ckpt/torch_import.py `bootstrap_pretrained` :269 and
`load_torch_replknet_backbone` :358).

The port's modules carry the reference's names, which are the names of
the RepLKNet ImageNet release and of torchvision's resnet18, so loading is
a merge by name: every floating-point entry of the checkpoint whose name
and shape match a parameter or BN statistic of the target module is
copied (BN's `num_batches_tracked` counters are left alone, as the JAX
trees have none). A single-image stem checkpoint inflates into a
multi-image stem by concatenating its kernel along the input channels and
dividing by the image count (resnet_encoder.py:62-70).
"""

from __future__ import annotations

import glob
import os
import sys
from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from .io import load_torch_checkpoint

# ImageNet checkpoint filenames the reference hardcodes per size
# (repdepth.py:84-88, replk_matching_adapter.py:46-51); XL takes the
# official RepLKNet release name
REPLK_IMAGENET_FILES = {
    "b": "RepLKNet-31B_ImageNet-1K_224.pth",
    "l": "RepLKNet-31L_ImageNet-22K.pth",
    "xl": "RepLKNet-XL_MegData73M_pretrain.pth",
}


@torch.no_grad()
def merge_state_dict(sd: Dict[str, torch.Tensor], module: nn.Module,
                     num_input_images: int = 1) -> Tuple[int, List[str]]:
    """Copy the entries of `sd` into `module`'s parameters and BN
    statistics by name (see the module docstring). Returns (tensors
    loaded, names of the module left as they were)."""
    loaded, missing = 0, []
    for name, t in module.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        a = sd.get(name)
        if a is None:
            missing.append(name)
            continue
        a = a.float()
        if (a.dim() == 4 and a.shape != t.shape
                and a.shape[1] * num_input_images == t.shape[1]):
            a = torch.cat([a] * num_input_images, 1) / num_input_images
        if a.shape != t.shape:
            missing.append(f"{name} (shape {tuple(a.shape)} vs {tuple(t.shape)})")
            continue
        t.copy_(a)
        loaded += 1
    return loaded, missing


def load_torch_replknet_backbone(path: str, module: nn.Module,
                                 num_input_images: int = 1,
                                 verbose: bool = True) -> Tuple[int, List[str]]:
    """Load a raw RepLKNet ImageNet checkpoint into one backbone module
    (the `pretrained=` path of replknet.py:261-268)."""
    loaded, missing = merge_state_dict(load_torch_checkpoint(path), module,
                                       num_input_images)
    if verbose and missing:
        print(f"[torch_import] {loaded} loaded, {len(missing)} missing; "
              f"first missing: {missing[:5]}")
    return loaded, missing


def bootstrap_pretrained(model: nn.Module, opt, verbose: bool = True) -> None:
    """Load the RepLKNet ImageNet checkpoint into both backbones of the
    RepDepth `model` (`mono_encoder` and the matching encoder's `replk`)
    and, when `opt.backbone_weights` holds a `resnet18*.pth`, torchvision's
    resnet18 into the 2-image pose encoder, as the reference's
    constructors do (repdepth.py:84-111, 155). A missing RepLKNet file is
    an error, not a silent random init; the resnet18 file is optional,
    with a warning (the reference downloads it at run time)."""
    fname = REPLK_IMAGENET_FILES.get(opt.rep_size, f"RepLKNet-{opt.rep_size}.pth")
    path = os.path.join(opt.backbone_weights, fname)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"--weights_init pretrained: backbone checkpoint {path!r} not "
            "found. Download the RepLKNet ImageNet release there, point "
            "--backbone_weights at its directory, or pass "
            "--weights_init scratch to (knowingly) train from random "
            "backbones.")
    sd = load_torch_checkpoint(path)
    n_mono, miss_m = merge_state_dict(sd, model.mono_encoder)
    n_match, _ = merge_state_dict(sd, model.encoder.replk)
    if n_mono == 0 or n_match == 0:
        raise ValueError(
            f"backbone checkpoint {path!r} matched no parameters "
            f"(mono {n_mono}, matching {n_match}) — wrong --rep_size?")
    if verbose:
        print(f"[bootstrap] {fname}: mono_encoder {n_mono} tensors, "
              f"matching encoder {n_match} tensors "
              f"(adapters/decoders stay at init: {len(miss_m)} skipped)")

    pose_files = sorted(glob.glob(os.path.join(opt.backbone_weights,
                                               "resnet18*.pth")))
    if not pose_files:
        if verbose:
            print("[bootstrap] WARNING: no resnet18*.pth in "
                  f"{opt.backbone_weights!r} — pose encoder starts from "
                  "random (the reference uses torchvision pretrained=True)")
        return
    n_pose, _ = merge_state_dict(load_torch_checkpoint(pose_files[0]),
                                 model.pose_encoder.encoder, num_input_images=2)
    if n_pose == 0:
        print(f"[bootstrap] WARNING: {pose_files[0]!r} matched 0 "
              "pose_encoder tensors (wrong or corrupt file?) — pose "
              "encoder starts from random", file=sys.stderr)
    elif verbose:
        print(f"[bootstrap] {os.path.basename(pose_files[0])}: pose_encoder "
              f"{n_pose} tensors (2-image stem inflated)")
