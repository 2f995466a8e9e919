"""Per-block adapter ablation (JAX counterpart: ppeadepth_tpu/eval/
ablation.py; the reference's evaluate_depth_layer.py:353-417).

The reference disables each encoder block's adapter in turn (`blk.test_id
= -1`) and logs AbsRel and a1 per block: the layer-importance study behind
PPEA-Depth's progressive adaptation. Disabling an adapter zeroes its
output, and every adapter ends in a projection (`D_fc2`) whose weight and
bias gate that output, so an ablation here is a state_dict edit: no model
surgery, the same eval on other weights.

Blocks are named by the port's (the reference's) state_dict prefixes, e.g.
`encoder.replk.stages.0.blocks.1.mlp_adapter`;
`ckpt.convert.torch_module_name` maps the JAX names onto them.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

_ADAPTERS = ("adapter", "mlp_adapter")
_INDEX = re.compile(r"\d+")


def adapter_block_paths(state_dict: Dict[str, torch.Tensor],
                        submodule: str) -> List[str]:
    """The distinct block prefixes under `submodule` that own an adapter
    (an `adapter` or `mlp_adapter` child), in (stage, block) order."""
    blocks = set()
    for name in state_dict:
        parts = name.split(".")
        if parts[0] != submodule:
            continue
        for i, part in enumerate(parts):
            if part in _ADAPTERS:
                blocks.add(".".join(parts[:i + 1]))
                break
    return sorted(blocks, key=lambda b: [int(n) for n in _INDEX.findall(b)])


def zero_adapter(state_dict: Dict[str, torch.Tensor],
                 block: str) -> Dict[str, torch.Tensor]:
    """A copy of `state_dict` with the adapter of `block` gated off: its
    `D_fc2` zeroed, or its `D_fc1` where it has no `D_fc2` (neither: an
    unchanged copy). The tensors not zeroed are shared with `state_dict`,
    which is left as it was."""
    out = dict(state_dict)
    inside = [k for k in out if k.startswith(block + ".")]
    for layer in ("D_fc2", "D_fc1"):
        hit = [k for k in inside if layer in k.split(".")]
        if hit:
            for k in hit:
                out[k] = torch.zeros_like(out[k])
            break
    return out


def run_block_ablation(eval_fn: Callable[[Dict[str, torch.Tensor]], np.ndarray],
                       state_dict: Dict[str, torch.Tensor],
                       submodules: Sequence[str] = ("encoder", "mono_encoder"),
                       out_path: str = "repl.txt"):
    """eval_fn(state_dict) -> mean_errors [7]. Ablates each adapter block
    of `submodules` in order and writes one line per block, `<block>
    <abs_rel> <a1>`, to `out_path` (evaluate_depth_layer.py:406-417).
    Returns [(block, mean_errors)]."""
    results = []
    with open(out_path, "w") as f:
        for block in (b for sub in submodules
                      for b in adapter_block_paths(state_dict, sub)):
            errors = eval_fn(zero_adapter(state_dict, block))
            f.write(f"{block} {errors[0]:.5f} {errors[4]:.5f}\n")
            f.flush()
            results.append((block, errors))
    return results
