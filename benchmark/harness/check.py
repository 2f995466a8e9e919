"""The comparison that decides `correct`: what the timed path produced
against the plain reference, run after the window on the same seeded
state_dict and inputs.

Training: the program's first steps went through the window's own call
in set-up; the reference follows the first `check` of them. Compared
(the limits file of a cell names which):
  loss_gap    the first step's loss, relative;
  grad_gap    the first step's gradient, as the program's Adam holds it
              (the first moment over 1 - beta1), by the median leaf;
  update_gap  each parameter's change over the checked steps, by the
              median leaf, leaving out leaves whose reference gradient is
              under a thousandth of the median leaf's (they move by
              round-off alone);
  bn_gap      each BN running statistic's change over the steps, by the
              median buffer.
A gap by leaf is |norm(program) - norm(reference)| over the larger of the
reference's norm of that leaf and of the median leaf. `calibrate.py`
reads more beside them from the same readings, as a look only.

Serving: the depth that sampled timed requests returned, as disparity
(the network's sigmoid output, in [0, 1]) against the reference's:
  disp_mean   mean |difference| over the sampled answers' pixels;
  disp_max    the largest |difference|.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import nets
from reference import train as ref_train

BETA1 = 0.9
REF_ROWS = 8  # rows of a served batch the reference takes at a time


def _median(d):
    return float(np.median(list(d.values()))) if d else 0.0


def floats(d):
    return {k: float(v) for k, v in d.items()}


def norms_of_change(now: dict, start: dict) -> dict:
    return {k: (v.detach().float() - start[k].float()).norm() for k, v in now.items()}


def bn_buffers(named_buffers) -> dict:
    return {n: b for n, b in named_buffers
            if n.endswith(("running_mean", "running_var"))}


def reference_train(cfg, sd, batches, draws, drop_seed, lr, device):
    """The reference's readings over the checked steps: {"loss": [...],
    "grad": {leaf: norm}, "update": {leaf: norm}, "bn": {buffer: norm},
    "bins": (d min, d max)}."""
    with torch.device(device):
        model = nets.RepDepth(cfg)
    model.load_state_dict(sd, strict=True)
    tr = ref_train.Trainer(model, lr, drop_seed)
    out = {"loss": [], "parts": []}
    with nets.tf32_off():
        for i, (b, d) in enumerate(zip(batches, draws)):
            loss, grads, parts = tr.step(b, d)
            out["loss"].append(float(loss))
            out["parts"].append([float(p) for p in parts])
            if i == 0:
                out["grad"] = floats(grads)
    out["update"] = floats(norms_of_change(tr.params, sd))
    out["bn"] = floats(norms_of_change(bn_buffers(model.named_buffers()), sd))
    out["bins"] = (float(tr.min_bin) - 0.1, float(tr.max_bin) - 10.0)
    return out


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """{leaf: |prog - ref| / max(ref, the median leaf's ref)} over the
    reference's leaves (those in `keep`, if given); a leaf the program
    lacks reads infinite."""
    keys = [k for k in ref if keep is None or k in keep]
    med = _median({k: ref[k] for k in keys})
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) if k in prog
            else math.inf for k in keys}


def moving(ref_grad: dict) -> set:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's; the others move under Adam by round-off alone."""
    med = _median(ref_grad)
    return {k for k, v in ref_grad.items() if v >= 1e-3 * med}


def _median_gap(prog, ref, keep=None) -> float:
    """The median leaf's gap; infinite where a leaf is missing."""
    gaps = list(leaf_gaps(prog, ref, keep).values())
    if not gaps or not all(map(math.isfinite, gaps)):
        return math.inf
    return float(np.median(gaps))


def compare_train(prog: dict, ref: dict) -> dict:
    """The numbers compared, from the program's and the reference's
    readings (the same keys)."""
    loss = (abs(prog["loss"][0] - ref["loss"][0]) / max(abs(ref["loss"][0]), 1e-30)
            if len(prog["loss"]) == len(ref["loss"]) else math.inf)
    return {"loss_gap": loss,
            "grad_gap": _median_gap(prog["grad"], ref["grad"]),
            "update_gap": _median_gap(prog["update"], ref["update"],
                                      moving(ref["grad"])),
            "bn_gap": _median_gap(prog["bn"], ref["bn"])}


def reference_disp(cfg, sd, request, mode, device):
    """The reference's disparity [B, H, W] for one served request."""
    with torch.device(device):
        model = nets.RepDepth(cfg)
    model.load_state_dict(sd, strict=True)
    model.eval()

    def img(a):
        return torch.as_tensor(a).to(device).float().div(255).permute(0, 3, 1, 2)

    out = []
    B = request[0].shape[0]
    with torch.no_grad(), nets.tf32_off():
        for r in range(0, B, REF_ROWS):
            rows = slice(r, r + REF_ROWS)
            x = img(request[0][rows])
            if mode == "teacher":
                disp = model.forward_mono(x)[("disp", 0)]
            else:
                lk = img(request[1][rows])
                K = torch.as_tensor(request[2][rows]).to(device)
                invK = torch.as_tensor(request[3][rows]).to(device)
                T = model.pose_pair(lk, x, invert=True)[2]
                disp = model.forward_multi(x, lk[:, None], T[:, None], K, invK,
                                           0.1, 10.0)[0][("disp", 0)]
            out.append(disp[:, 0].cpu())
    return torch.cat(out).numpy()


def depth_to_disp(depth, min_depth, max_depth):
    lo, hi = 1.0 / max_depth, 1.0 / min_depth
    return (1.0 / depth.astype(np.float64) - lo) / (hi - lo)


def compare_serve(answers, refs, o) -> dict:
    """answers: [(entry, depth [B, H, W])]; refs: {entry: disparity}."""
    diffs = [np.abs(depth_to_disp(d, o["min_depth"], o["max_depth"]) - refs[e])
             for e, d in answers]
    if not diffs:
        return {"disp_mean": math.inf, "disp_max": math.inf}
    flat = np.concatenate([d.ravel() for d in diffs])
    if not np.all(np.isfinite(flat)):
        return {"disp_mean": math.inf, "disp_max": math.inf}
    return {"disp_mean": float(flat.mean()), "disp_max": float(flat.max())}


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number finite and at
    or under its limit, and every limit read."""
    checks = {k: {"value": numbers.get(k, math.inf), "limit": v}
              for k, v in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
