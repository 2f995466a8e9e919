"""Convert a reference torch checkpoint into a checkpoint folder of the
port (JAX counterpart: ppeadepth_tpu/convert.py, which writes flax
msgpack):

    python -m ppeadepth_tpu_torch.convert --torch <model.pth> --out <folder>
        [--rep_size b] [--height 192] [--width 640] [--no-adapter] [--dc]
        [--min_depth_bin X --max_depth_bin Y]   (else read from track.pth)

The folder holds model.pth (the whole RepDepth under the reference's
names: the port uses them, so no layout changes; entries the reference
file lacks keep a seeded init), track.json and opt.json, and loads with
`--load_weights_folder` and `InferenceSession(checkpoint=...)`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch


def main(argv=None):
    p = argparse.ArgumentParser("ppeadepth_tpu_torch.convert")
    p.add_argument("--torch", required=True, dest="torch_path")
    p.add_argument("--out", required=True)
    p.add_argument("--rep_size", default="b")
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=640)
    # --no-adapter converts the plain (adapter-free) RepDepth
    p.add_argument("--adapter", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--adpt_test", type=int, default=4)
    p.add_argument("--dc", action="store_true")
    p.add_argument("--dec_id", type=int, default=1)
    p.add_argument("--min_depth_bin", type=float, default=None)
    p.add_argument("--max_depth_bin", type=float, default=None)
    a = p.parse_args(argv)

    from .ckpt import io as ckpt_io
    from .models import RepDepth, init_weights
    from .options import Config

    opt = Config(adapter=a.adapter, rep_size=a.rep_size, height=a.height,
                 width=a.width, adpt_test=a.adpt_test, dc=a.dc,
                 dec_id=a.dec_id).with_mode_presets()
    model = RepDepth(opt)
    init_weights(model, torch.Generator().manual_seed(0))
    loaded, missing, _ = ckpt_io.merge_state_dict(
        model, ckpt_io.load_torch_checkpoint(a.torch_path))
    print(f"converted {len(loaded)} tensors; {len(missing)} missing/untouched")

    # depth bins: flag > sibling track.pth > the defaults
    min_bin, max_bin = 0.1, 10.0
    track_pth = os.path.join(os.path.dirname(a.torch_path), "track.pth")
    if os.path.exists(track_pth):
        t = torch.load(track_pth, map_location="cpu", weights_only=True)
        min_bin = float(t.get("min_depth_bin", min_bin))
        max_bin = float(t.get("max_depth_bin", max_bin))
    if a.min_depth_bin is not None:
        min_bin = a.min_depth_bin
    if a.max_depth_bin is not None:
        max_bin = a.max_depth_bin

    os.makedirs(a.out, exist_ok=True)
    torch.save(model.state_dict(), os.path.join(a.out, "model.pth"))
    with open(os.path.join(a.out, "track.json"), "w") as f:
        json.dump({"height": opt.height, "width": opt.width,
                   "min_depth_bin": min_bin, "max_depth_bin": max_bin,
                   "step": 0}, f)
    with open(os.path.join(a.out, "opt.json"), "w") as f:
        json.dump(dataclasses.asdict(opt), f, indent=2)
    print(f"wrote a checkpoint folder to {a.out}")
    return a.out


if __name__ == "__main__":
    main(sys.argv[1:])
