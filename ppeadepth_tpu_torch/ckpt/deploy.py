"""Deploy-time structural re-parameterisation over a torch state_dict
(JAX counterpart: ckpt/deploy.py `structural_reparam`; reference
replknet.py:309-312).

Folds BN into every ReparamLKConv and merges its parallel small-kernel
branch into the large kernel: `*.large_kernel.lkb_origin.*` +
`*.large_kernel.small_conv.*` become `*.large_kernel.lkb_reparam.{weight,
bias}`, the state of a `merged=True` model.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..kernels.lk_conv import merge_reparam_kernels

_LK = ".large_kernel."


def structural_reparam(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Returns a new state_dict for the merged model; `sd` is not changed."""
    out = dict(sd)
    prefixes = {k[: k.index(_LK) + len(_LK)] for k in sd if _LK in k}
    for pre in sorted(prefixes):
        def bn(branch):
            return {n: out.pop(f"{pre}{branch}.bn.{n}") for n in
                    ("weight", "bias", "running_mean", "running_var")}

        lk_kernel = out.pop(pre + "lkb_origin.conv.weight")
        lk_bn = bn("lkb_origin")
        small_kernel = out.pop(pre + "small_conv.conv.weight", None)
        small_bn = bn("small_conv") if small_kernel is not None else None
        for branch in ("lkb_origin", "small_conv"):
            out.pop(f"{pre}{branch}.bn.num_batches_tracked", None)
        eq_k, eq_b = merge_reparam_kernels(lk_kernel, lk_bn, small_kernel,
                                           small_bn)
        out[pre + "lkb_reparam.weight"] = eq_k
        out[pre + "lkb_reparam.bias"] = eq_b
    return out
