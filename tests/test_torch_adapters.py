"""Every BAdapter variant with the transition and input adapters
(`--adapter --adpt_test {1, 2, 0, 5, 6} --trans --input --mono_trans
--mono_input`) against JAX on the CPU, in f32, at rep_size "t", 64x96:
the teacher's and the student's disparities in training form, merged, and
merged with every ConvFFN folded into kernel-B operands (the deploy path,
here through the plain versions), on the same converted weights with every
adapter drawn away from zero; the state_dict names against the JAX
exporter's; the init rules; and the freeze labels against JAX
`param_labels`, under stage 1 and under `--train_cs --dc --dec_id 5/6`.

Variants 1/2 are Linear-GELU-Linear, 0 (and 3, >= 7) Conv3x3-GELU-Conv3x3,
5 puts adapters in the ConvFFNs only (ratio 0.25), 6 in the blocks only
(as 4); under 2 the ConvFFN adapter is C/2 wide, so kernel B's packed
hidden width is 4.5C. atol 2e-4 as tests/test_torch_replknet.py (f32
summation order through the tiny net)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppeadepth_tpu.ckpt.torch_import import export_state_dict
from ppeadepth_tpu.models import RepDepth as JRepDepth
from ppeadepth_tpu.train.freeze import param_labels as jax_labels
from ppeadepth_tpu_torch.ckpt.convert import state_dict_from_jax
from ppeadepth_tpu_torch.ckpt.deploy import structural_reparam
from ppeadepth_tpu_torch.kernels.ffn_fused import K_TILE
from ppeadepth_tpu_torch.models import RepDepth, init_weights
from ppeadepth_tpu_torch.models.adapters import BAdapter
from ppeadepth_tpu_torch.models.replknet import ConvFFN, RepLKBlock
from ppeadepth_tpu_torch.train.freeze import param_labels
from tests.test_torch_student import T_GIVEN, inputs  # noqa: F401 (fixture)
from tests.torch_parity import (
    TINY, compile_reference, jax_repdepth, jax_shapes, nhwc_to_torch)
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

ATOL = 2e-4
VARIANTS = [1, 2, 0, 5, 6]


def breadth(adpt_test, **kw):
    return TINY.replace(adpt_test=adpt_test, trans=True, input=True,
                        mono_trans=True, mono_input=True, **kw)


def _jax_disps(opt, variables, img, lk, K, invK):
    """The teacher's and the student's disparities (eval mode), the student
    at T_GIVEN."""
    model = JRepDepth(opt)

    def fn(v, img, lk, K2, invK2, T):
        mono = model.apply(v, img, False, method=JRepDepth.forward_mono)
        multi, _, _ = model.apply(v, img, lk[:, None], T[:, None], K2, invK2,
                                  0.1, 10.0, False,
                                  method=JRepDepth.forward_multi)
        return mono[("disp", 0)], multi[("disp", 0)]

    args = (variables, img, lk, K, invK, jnp.asarray(T_GIVEN))
    return [np.asarray(r) for r in compile_reference(fn, *args)(*args)]


def _port_disps(model, img, lk, K, invK):
    t = torch.from_numpy
    x = nhwc_to_torch(img)
    with torch.inference_mode():
        mono = model.forward_mono(x)[("disp", 0)]
        multi = model.forward_multi(
            x, nhwc_to_torch(lk)[:, None], t(T_GIVEN)[:, None], t(K), t(invK),
            0.1, 10.0)[0][("disp", 0)]
    return [d.permute(0, 2, 3, 1).numpy() for d in (mono, multi)]


def _check_routing(model, adpt_test, C):
    """The variant's adapters where the JAX routing puts them."""
    blocks = [m for m in model.modules() if isinstance(m, RepLKBlock)]
    ffns = [m for m in model.modules() if isinstance(m, ConvFFN)]
    assert all((b.adapter is None) == (adpt_test == 5) for b in blocks)
    assert all((f.mlp_adapter is None) == (adpt_test == 6) for f in ffns)
    if adpt_test != 5:
        a = blocks[0].adapter
        assert isinstance(a, BAdapter)
        linear = (isinstance(a.D_fc1, torch.nn.Linear),
                  isinstance(a.D_fc2, torch.nn.Linear))
        assert linear == {1: (True, True), 2: (True, True), 0: (False, False),
                          6: (False, True)}[adpt_test]
    if adpt_test != 6:
        hidden = ffns[0].mlp_adapter.D_fc1.out_features
        assert hidden == (C // 2 if adpt_test == 2 else C // 4)


@pytest.mark.parametrize("adpt_test", VARIANTS)
def test_variant_forwards_match_jax(adpt_test, inputs):  # noqa: F811
    """Teacher and student disparities of the JAX training form, against the
    port's training form, merged form, and merged form with the ConvFFNs
    folded (packed hidden 4C + the adapter's width, padded to K_TILE)."""
    opt = breadth(adpt_test)
    params, stats = jax_repdepth(opt)
    ref = _jax_disps(opt, {"params": params, "batch_stats": stats}, *inputs)
    sd = state_dict_from_jax(params, stats)
    for form in ("train", "merged", "folded"):
        model = RepDepth(opt, merged=form != "train").eval()
        model.load_state_dict(sd if form == "train" else structural_reparam(sd),
                              strict=True)
        _check_routing(model, adpt_test, 16)
        if form == "folded":
            model.fold_ffn(torch.float32)
            for f in (m for m in model.modules() if isinstance(m, ConvFFN)):
                C = f.preffn_bn.num_features
                ca = 0 if f.mlp_adapter is None else f.mlp_adapter.D_fc1.out_features
                assert f.folded_w_up.shape == (-(-(4 * C + ca) // K_TILE) * K_TILE, C)
        for got, want in zip(_port_disps(model, *inputs), ref):
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL,
                                       err_msg=f"{adpt_test} {form}")


def test_state_dict_names_match_jax_export():
    """The port's parameter and buffer names and shapes are the JAX
    exporter's (ppeadepth_tpu/ckpt/torch_import.export_state_dict) for a
    Linear variant and a Conv variant with every breadth adapter."""
    for adpt_test in (2, 0):
        params, stats = jax_repdepth(breadth(adpt_test))
        ref = {k: v.shape for k, v in export_state_dict(params, stats).items()}
        got = {k: tuple(v.shape) for k, v in
               RepDepth(breadth(adpt_test)).state_dict().items()
               if not k.endswith("num_batches_tracked")}
        assert got == ref
        assert "mono_encoder.trans_adapters.2.D_fc1.weight" in got
        assert "encoder.replk.input_adapter.bn2.running_var" in got


def test_init_rules():
    """init_weights: the transition adapters' D_fc2 drawn (PARITY §2.4),
    the input adapter's D_fc2 and every block and ConvFFN adapter's D_fc2
    zero, for a Linear and a Conv variant."""
    for adpt_test in (2, 0):
        model = RepDepth(breadth(adpt_test))
        init_weights(model, torch.Generator().manual_seed(0))
        for name, p in model.named_parameters():
            if not name.endswith("D_fc2.weight"):
                continue
            if ".trans_adapters." in name:
                assert p.abs().min() > 0, name
            else:
                assert not p.any(), name


def _jax_label_names(opt):
    """JAX `param_labels` of `opt` under the port's names ({name: label})."""
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                    jax_shapes(opt)["params"])
    labels = jax_labels(params, opt)
    marks = jax.tree_util.tree_map(
        lambda p, lab: np.full(p.shape, lab == "trainable", np.float32),
        params, labels)
    return {k: "trainable" if v.numel() and bool(v.flatten()[0]) else "frozen"
            for k, v in state_dict_from_jax(marks, {}).items()}


@pytest.mark.parametrize("mode", ["stage1", "dc5", "dc6"])
def test_freeze_labels_match_jax(mode):
    """The port's labels equal JAX's name by name: stage 1 with every
    breadth adapter; --train_cs --dc --dec_id 5 and 6, where the transition
    and input adapters hold "adapter" but lie in no (stage, block) pair,
    so both packages freeze them."""
    kw = {} if mode == "stage1" else dict(train_cs=True, dc=True,
                                          dec_id=int(mode[-1]))
    opt = breadth(2, **kw)
    got = param_labels(RepDepth(opt), opt)
    assert got == _jax_label_names(opt)
    trans = {v for k, v in got.items() if ".trans_adapters." in k
             or ".input_adapter." in k}
    assert trans == ({"trainable"} if mode == "stage1" else {"frozen"})
