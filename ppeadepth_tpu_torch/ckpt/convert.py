"""JAX parameter trees -> torch state_dict with the reference's names.

The port's counterpart of `ppeadepth_tpu/ckpt/torch_import.export_state_dict`
(torch_import.py:173-193, naming rules `_to_torch_name` :34-81), in numpy
and torch only. Input is the nested dicts of numpy arrays (`params`,
`batch_stats`) of a flax RepDepth (or any of its subtrees); output loads
into the port's modules with `load_state_dict(strict=True)`.

Layout transforms:
  conv      flax HWIO [kh, kw, I, O]  -> torch OIHW [O, I, kh, kw]
  depthwise flax [k, k, 1, C]         -> torch [C, 1, k, k]
  Dense     flax [in, out]            -> torch Linear [out, in]
  deconv    [kh, kw, I, O]            -> torch ConvTranspose [I, O, kh, kw]
  BN        scale/bias/mean/var       -> weight/bias/running_mean/running_var
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_LIST_ATTR = re.compile(
    r"(stem|stages|blocks|transitions|upconvs_0|upconvs_1|upconv_0|upconv_1|"
    r"dispconvs|layer1|layer2|layer3|layer4|up_adapters|trans_adapters|"
    r"trans_drop_paths)_(\d+)")
_RENAMES = {
    "expand": "0",          # Transition part 0 (1x1 conv-bn-relu)
    "down": "1",            # Transition part 1 (dw 3x3 s2)
    "disp_conv": "disp_convs.0",
    "trans_adapters": "trans_adpt",
    "reduce_conv": "reduce_conv.0",
    "downsample_conv": "downsample.0",
    "downsample_bn": "downsample.1",
    "squeeze": "net.0",
    "pose_0": "net.1",
    "pose_1": "net.2",
    "pose_2": "net.3",
}
_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}


def torch_module_name(path: Tuple[str, ...]) -> str:
    """Flax module path (without the leaf) -> the reference's module name."""
    parts = []
    for p in path:
        m = _LIST_ATTR.fullmatch(p)
        if m:
            name = "adapters" if m.group(1) == "up_adapters" else m.group(1)
            parts.append(f"{name}.{m.group(2)}")
        else:
            parts.append(_RENAMES.get(p, p))
    return re.sub(r"^pose_encoder\.", "pose_encoder.encoder.", ".".join(parts))


def _is_bn(path: Tuple[str, ...]) -> bool:
    return "bn" in path[-1] or path[-1] in ("prelkb_bn", "preffn_bn", "norm")


def _flatten(tree: Dict, prefix=()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_jax(params: Dict, batch_stats: Dict) -> Dict[str, torch.Tensor]:
    """Convert flax (params, batch_stats) nested dicts of arrays into a
    torch state_dict with the reference's names and torch layouts."""
    out = {}
    for tree in (params, batch_stats):
        for key, val in _flatten(tree):
            *path, leaf = key
            path = tuple(path)
            if path and _is_bn(path):
                tname = _BN_LEAVES[leaf]
            else:
                tname = {"kernel": "weight"}.get(leaf, leaf)
            name = torch_module_name(path)
            a = np.asarray(val, dtype=np.float32)
            if leaf == "kernel":
                if a.ndim == 4:
                    if "deconv_adpt" in ".".join(path):
                        a = a.transpose(2, 3, 0, 1)
                    else:
                        a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
                elif a.ndim == 2:
                    a = a.T
            out[f"{name}.{tname}" if name else tname] = torch.tensor(a)
    return out
