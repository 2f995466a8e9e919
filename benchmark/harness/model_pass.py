"""One unit of work of the plain reference at the cell's shapes, on the
meta device (no memory, no time): its model FLOPs, counted by
`FlopCounterMode`, and the calls it makes at the sites where the program
launches a kernel of its own, from which `roofline/<kernel>.py` works out
each of the program's launches.

A unit is what a loop (`loops/<kind>.py`) says one step or request is
made of: a list of passes, each {"pass": "train" | "teacher" | "student",
"batch": rows, "form": "train" | "merged", "dtype": "bf16" | "f32"}. A
training pass is a forward and backward with the frozen set excluded as
the step excludes it; a teacher or student pass is a request's forward.

Sites, each call recorded as a dict with its "site":
  ReparamLKConv  a block's large and small depthwise convs: "x" [B, C, H,
                 W], "k", "small_k", and "grad" (whether the input needs
                 its gradient);
  ConvFFN        a block's FFN with its adapter: "x", "hidden", "adapter";
  plane_sweep    one lookup frame's cost volume: "cur" [B, C, H, W], "bins";
  warp           one frame's loss warp: "img" [B, H, W, 3], "grad" (whether
                 the coordinates need their gradient), "branch" (the loss
                 branch it belongs to, counted from 0).
Counted once a process for each configuration and unit."""

from __future__ import annotations

import contextlib
import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference import nets
from reference import train as ref_train


class Sites(contextlib.ContextDecorator):
    """Records the calls of the reference's kernel sites inside the block."""

    def __enter__(self):
        self.calls, self.branch = [], -1
        self._saved = [(nets.ReparamLKConv, "forward"), (nets.ConvFFN, "forward"),
                       (nets, "plane_sweep"), (ref_train, "_warp"),
                       (ref_train, "_branch")]
        self._saved = [(o, n, getattr(o, n)) for o, n in self._saved]
        rec, calls = self, self.calls
        lk, ffn, sweep, warp, branch = (f for _, _, f in self._saved)

        def lk_forward(mod, x):
            calls.append({"site": "ReparamLKConv", "x": tuple(x.shape),
                          "k": mod.lkb_origin.conv.weight.shape[-1],
                          "small_k": mod.small_conv.conv.weight.shape[-1],
                          "grad": x.requires_grad and torch.is_grad_enabled()})
            return lk(mod, x)

        def ffn_forward(mod, x, mask):
            calls.append({"site": "ConvFFN", "x": tuple(x.shape),
                          "hidden": mod.pw1.conv.out_channels,
                          "adapter": mod.mlp_adapter.D_fc1.out_features})
            return ffn(mod, x, mask)

        def plane_sweep(cur, lk_, T, K, invK, bins, *a, **k):
            calls.append({"site": "plane_sweep", "cur": tuple(cur.shape),
                          "bins": bins.shape[0]})
            return sweep(cur, lk_, T, K, invK, bins, *a, **k)

        def _warp(img, coords):
            calls.append({"site": "warp", "img": tuple(img.shape),
                          "grad": coords.requires_grad and torch.is_grad_enabled(),
                          "branch": rec.branch})
            return warp(img, coords)

        def _branch(*a, **k):
            rec.branch += 1
            return branch(*a, **k)

        for (o, n, _), f in zip(self._saved, (lk_forward, ffn_forward, plane_sweep,
                                              _warp, _branch)):
            setattr(o, n, f)
        return self

    def __exit__(self, *exc):
        for o, n, f in self._saved:
            setattr(o, n, f)
        return False


def _run_pass(model, o, p):
    B, H, W = p["batch"], o["height"], o["width"]
    img = torch.rand(B, H, W, 3)
    K = torch.rand(B, 4, 4)
    model.train(p["pass"] == "train")
    if p["pass"] == "train":
        for n, w in model.named_parameters():
            w.requires_grad_(ref_train.trainable(n, o))
        b = {}
        for f in ref_train.FRAMES:
            b[("color", f, 0)] = b[("color_aug", f, 0)] = img
        for s in (0, 2):
            b[("K", s)] = b[("inv_K", s)] = K
        draws = {"aug_u": torch.rand(B), "noise_mono": torch.rand(B, H, W, 1),
                 "noise_multi": torch.rand(B, H, W, 1)}
        loss = ref_train.losses(model, b, torch.tensor(0.1), torch.tensor(10.0),
                                draws, None)[0]
        loss.backward()
        return
    x = img.permute(0, 3, 1, 2)
    with torch.no_grad():
        if p["pass"] == "teacher":
            model.forward_mono(x)
        else:
            T = model.pose_pair(x, x, invert=True)[2]
            model.forward_multi(x, x[:, None], T[:, None], K, K, 0.1, 10.0)


@functools.lru_cache(maxsize=None)
def _count(cfg_json: str, unit_json: str):
    cfg, unit = json.loads(cfg_json), json.loads(unit_json)
    flop, calls = 0, []
    with torch.device("meta"):
        model = nets.RepDepth(cfg)
        for p in unit:
            with FlopCounterMode(display=False) as fc, Sites() as sites:
                _run_pass(model, cfg["options"], p)
            flop += fc.get_total_flops()
            calls.append(sites.calls)
    return flop, calls


def count(cfg: dict, unit: list):
    """(model FLOPs of one unit, [each pass's site calls])."""
    return _count(json.dumps(cfg, sort_keys=True), json.dumps(unit, sort_keys=True))
