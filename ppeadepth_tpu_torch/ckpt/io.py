"""Checkpoint save and load in the reference's own format (JAX counterpart:
ckpt/io.py, which writes the same artifact set in flax msgpack).

A checkpoint is a folder (trainer.py:1290-1321, 1346-1381):
  model.pth   the whole RepDepth state_dict under the reference's names,
              CPU tensors (frozen backbones included), which
              `ppeadepth_tpu/ckpt/torch_import.load_torch_repdepth` reads;
  adam.pth    {"optimizer": Adam's state_dict, "scheduler": the
              learning-rate schedule's state_dict};
  track.json  {height, width, min_depth_bin, max_depth_bin, step};
  opt.json    the configuration.
Loading the model is a strict=False-like merge that reports missing and
unexpected keys; an optimizer state that does not fit starts fresh.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict

import torch


def save_checkpoint(folder: str, model, optimizer, scheduler, state,
                    opt) -> None:
    """Write the four files of a checkpoint of `model` (a RepDepth), its
    optimizer and scheduler, the `train.step.TrainState` `state` and the
    `options.Config` (or the JAX package's) `opt`."""
    os.makedirs(folder, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               os.path.join(folder, "model.pth"))
    torch.save({"optimizer": optimizer.state_dict(),
                "scheduler": scheduler.state_dict()},
               os.path.join(folder, "adam.pth"))
    with open(os.path.join(folder, "track.json"), "w") as f:
        json.dump({"height": opt.height, "width": opt.width,
                   "min_depth_bin": float(state.min_depth_bin),
                   "max_depth_bin": float(state.max_depth_bin),
                   "step": int(state.step)}, f)
    with open(os.path.join(folder, "opt.json"), "w") as f:
        json.dump(dataclasses.asdict(opt), f, indent=2)


def read_track(folder: str) -> Dict:
    """track.json of a checkpoint folder, {} when absent."""
    path = os.path.join(folder, "track.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def load_model(folder: str, model) -> Dict:
    """Merge `folder`/model.pth into `model` (strict=False-like: every
    entry whose name and shape match is loaded, the rest of the model keeps
    its values) and report missing and unexpected keys. Returns the
    folder's track.json ({} when absent)."""
    sd = torch.load(os.path.join(folder, "model.pth"), map_location="cpu",
                    weights_only=True)
    merge_state_dict(model, sd)
    return read_track(folder)


def merge_state_dict(model, sd: Dict[str, torch.Tensor]):
    """Load every entry of `sd` whose name and shape match `model`'s (the
    rest of the model keeps its values); report the missing and unexpected
    keys. Returns (loaded, missing, unexpected) name lists."""
    own = model.state_dict()
    fits = {k: v for k, v in sd.items() if k in own and v.shape == own[k].shape}
    missing = [k for k in own if k not in fits]
    unexpected = [k for k in sd if k not in own]
    model.load_state_dict(fits, strict=False)
    if missing or unexpected:
        print(f"[ckpt] model: {len(missing)} missing, {len(unexpected)} "
              f"unexpected keys (strict=False merge)")
    return list(fits), missing, unexpected


def load_adam(folder: str, optimizer, scheduler) -> bool:
    """Restore the optimizer and scheduler from `folder`/adam.pth; keep
    their fresh state, with a message, when the file is absent or does not
    fit (trainer.py:1373-1381). Returns whether it restored them."""
    path = os.path.join(folder, "adam.pth")
    if not os.path.exists(path):
        print(f"[ckpt] no {path}; starting from fresh Adam state")
        return False
    blob = torch.load(path, map_location="cpu", weights_only=True)
    try:
        optimizer.load_state_dict(blob["optimizer"])
        scheduler.load_state_dict(blob["scheduler"])
    except (KeyError, ValueError, TypeError, RuntimeError) as e:
        print(f"[ckpt] could not restore optimizer state ({e!r}); "
              "starting from fresh Adam state")
        return False
    return True


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A .pth as a flat {name: tensor} on the CPU; unwraps the "model" or
    "state_dict" entry of a training checkpoint (torch_import.py:234)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "state_dict"):
        if isinstance(blob.get(key), dict):
            blob = blob[key]
    return {k: v for k, v in blob.items() if torch.is_tensor(v)}
