"""Weights carried from JAX to the port, on a whole JAX RepDepth tree
(student and teacher encoders and decoders, pose nets):
`ckpt.convert.state_dict_from_jax` against
`ckpt/torch_import.export_state_dict`, strict loading into the port's
RepDepth, and the port's `structural_reparam` against JAX's."""

import numpy as np
import pytest
import torch

from ppeadepth_tpu.ckpt.deploy import structural_reparam as jax_reparam
from ppeadepth_tpu.ckpt.torch_import import export_state_dict
from ppeadepth_tpu_torch.ckpt.convert import (
    state_dict_from_jax, torch_module_name)
from ppeadepth_tpu_torch.ckpt.deploy import structural_reparam
from ppeadepth_tpu_torch.models import RepDepth
from tests.torch_parity import TINY, jax_repdepth
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def teacher():
    """The whole tree (the fixture keeps the name of the teacher-only tree
    these tests began with)."""
    return jax_repdepth()


def test_state_dict_matches_export(teacher):
    params, stats = teacher
    sd = state_dict_from_jax(params, stats)
    ref = export_state_dict(params, stats)
    assert sorted(sd) == sorted(ref)
    for k, v in sd.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    # the reference's names
    assert "mono_encoder.stem.0.conv.weight" in sd
    assert "mono_depth.upconvs_0.0.conv.conv.weight" in sd
    assert "mono_encoder.stages.0.blocks.0.large_kernel.lkb_origin.conv.weight" in sd
    for prefix in ("encoder.replk.", "encoder.reduce_conv.0.", "depth.",
                   "pose_encoder.encoder.", "pose.net."):
        assert any(k.startswith(prefix) for k in sd), prefix


@pytest.mark.parametrize("merged", [False, True])
def test_port_loads_strict(teacher, merged):
    sd = state_dict_from_jax(*teacher)
    if merged:
        sd = structural_reparam(sd)
        for enc in ("mono_encoder", "encoder.replk"):
            assert f"{enc}.stages.0.blocks.0.large_kernel.lkb_reparam.weight" in sd
        assert not any(".lkb_origin." in k or ".small_conv." in k for k in sd)
    model = RepDepth(TINY, merged=merged)
    model.load_state_dict(sd, strict=True)
    got = model.state_dict()
    for k, v in sd.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)


def test_structural_reparam_matches_jax(teacher):
    """Port reparam over the converted tree == JAX reparam then conversion
    (f32; BN folding reassociates, so 1e-6)."""
    params, stats = teacher
    ref = state_dict_from_jax(*jax_reparam(params, stats))
    got = structural_reparam(state_dict_from_jax(params, stats))
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        torch.testing.assert_close(got[k], v, rtol=1e-6, atol=1e-6, msg=k)


def test_structural_reparam_drops_branch_bn_counters(teacher):
    """A torch-made state_dict carries num_batches_tracked; the merged one
    keeps none for the removed branches and still loads strictly."""
    sd = RepDepth(TINY).state_dict()
    merged = structural_reparam(sd)
    assert not any("lkb_origin" in k or "small_conv" in k for k in merged)
    RepDepth(TINY, merged=True).load_state_dict(merged, strict=True)


@pytest.mark.parametrize("path,name", [
    (("mono_encoder", "stages_2", "blocks_3", "pw1", "bn"),
     "mono_encoder.stages.2.blocks.3.pw1.bn"),
    (("mono_encoder", "transitions_1", "down", "conv"),
     "mono_encoder.transitions.1.1.conv"),
    (("mono_depth", "disp_conv", "conv"), "mono_depth.disp_convs.0.conv"),
    (("pose_encoder", "layer1_0", "downsample_conv"),
     "pose_encoder.encoder.layer1.0.downsample.0"),
])
def test_torch_module_name(path, name):
    assert torch_module_name(path) == name
