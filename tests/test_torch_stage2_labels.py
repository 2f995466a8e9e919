"""The port's stage-2 (`--dc`) freeze labels and parameter tree against the
JAX package on the CPU: the dc labels, name for name against
`freeze.param_labels` through `torch_module_name`, for dec_id 1, 5, 6 and
10 (5 and 6 also at rep_size b, whose stage 2 holds blocks 30-35), and a
whole dc tree that loads with strict=True. Split from
tests/test_torch_stage2.py (the decoders against JAX), so that every port
test file stays behind tests/test_train_step.py in pytest-xdist's file
queue. No JAX compile.
"""

import pytest
import torch
from flax import traverse_util

from ppeadepth_tpu.train.freeze import param_labels as jax_labels
from ppeadepth_tpu_torch.ckpt.convert import (
    state_dict_from_jax, torch_module_name)
from ppeadepth_tpu_torch.models import RepDepth
from ppeadepth_tpu_torch.train.freeze import param_labels
from tests.test_torch_stage2 import DC
from tests.torch_parity import jax_repdepth, jax_shapes
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("rep_size,dec_id", [
    ("t", 1), ("t", 5), ("t", 6), ("t", 10), ("b", 5), ("b", 6)])
def test_dc_labels_match_jax(rep_size, dec_id):
    """Every parameter's label equals the JAX package's for the same path
    (the port's names are `torch_module_name` of the flax paths); at rep_size
    b dec_id 5/6 keep the encoder adapters of stage 2's blocks 34/35 and not
    those of blocks 3 or 30-33."""
    opt = DC.replace(rep_size=rep_size, dec_id=dec_id)
    shapes = jax_shapes(opt)["params"]
    ref = {}
    for key, label in traverse_util.flatten_dict(jax_labels(shapes, opt)).items():
        *path, leaf = key
        leaf = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
        ref[f"{torch_module_name(tuple(path))}.{leaf}"] = label
    with torch.device("meta"):
        model = RepDepth(opt)
    got = param_labels(model, opt)
    assert got == ref
    decoders = [n for n in got if n.split(".")[0] in ("depth", "mono_depth")]
    trained = [n for n in decoders if got[n] == "trainable"]
    assert trained and len(trained) < len(decoders)
    assert all("adapter" in n or "adpt" in n for n in trained)
    if rep_size == "b":
        kept = {n.split(".blocks.")[1].split(".")[0] for n in got
                if ".stages.2.blocks." in n and "adapter" in n
                and got[n] == "trainable"}
        assert kept == ({"35"} if dec_id == 5 else {"34", "35"})


@pytest.mark.parametrize("dec_id", [1, 10])
def test_dc_tree_loads_strict(dec_id):
    """A whole JAX dc tree (non-zero adapters and deconvs) loads into the
    port's RepDepth with strict=True, every stage-2 entry with its value."""
    opt = DC.replace(dec_id=dec_id)
    params, stats = jax_repdepth(opt)
    sd = state_dict_from_jax(params, stats)
    model = RepDepth(opt)
    model.load_state_dict(sd, strict=True)
    got = model.state_dict()
    stage2 = [k for k in sd if k.split(".")[0] in ("depth", "mono_depth")
              and ("adapter" in k or "adpt" in k)]
    assert len(stage2) == (2 * 6 if dec_id == 1 else 2 * 8)
    for k in stage2:
        assert got[k].abs().max() > 0 and torch.equal(got[k], sd[k]), k
