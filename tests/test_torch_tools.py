"""The port's offline tools against the JAX package's: the per-block
adapter ablation (`eval/ablation.py`: the block list and the zeroed
tensors on one converted tree, the repl.txt lines, and
`python -m ppeadepth_tpu_torch.evaluate_depth_layer` on the CPU), the
reference-checkpoint converter (`convert.py`) into an `InferenceSession`,
and `utils/vis.colorize`. No JAX compile."""

import json
import os
import sys

import numpy as np
import pytest
import torch
from flax import traverse_util

from ppeadepth_tpu.eval import ablation as JA
from ppeadepth_tpu.utils.vis import colorize as jax_colorize
from ppeadepth_tpu_torch import convert, evaluate_depth_layer
from ppeadepth_tpu_torch.ckpt.convert import state_dict_from_jax, torch_module_name
from ppeadepth_tpu_torch.eval import ablation as A
from ppeadepth_tpu_torch.options import parse_args
from ppeadepth_tpu_torch.serve import InferenceSession
from ppeadepth_tpu_torch.utils.vis import colorize
from tests.torch_parity import TINY, jax_repdepth, kitti_set
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

SUBS = ("encoder", "mono_encoder")


@pytest.fixture(scope="module")
def trees():
    params, stats = jax_repdepth()
    return params, stats, state_dict_from_jax(params, stats)


def test_block_list_matches_jax(trees):
    """The adapter blocks of each encoder, in (stage, block) order, are
    JAX's under the converter's names."""
    params, _, sd = trees
    for sub in SUBS:
        ref = [torch_module_name(p) for p in JA.adapter_block_paths(params, sub)]
        got = A.adapter_block_paths(sd, sub)
        assert got == ref
        assert len(got) == 10  # rep_size "t": 5 block pairs, both adapters


def test_zeroed_tensors_match_jax(trees):
    """For every block, the zeroed state_dict equals the converted zeroed
    JAX tree tensor for tensor; the input state_dict is left as it was."""
    params, stats, sd = trees
    before = {k: v.clone() for k, v in sd.items()}
    for sub in SUBS:
        for path in JA.adapter_block_paths(params, sub):
            ref = state_dict_from_jax(JA.zero_adapter(params, path), stats)
            got = A.zero_adapter(sd, torch_module_name(path))
            assert set(got) == set(ref)
            changed = [k for k in got if not torch.equal(got[k], sd[k])]
            assert changed and all("D_fc2" in k for k in changed)
            for k in got:
                assert torch.equal(got[k], ref[k]), k
    for k, v in before.items():
        assert torch.equal(sd[k], v), k


def test_zero_adapter_falls_back_to_d_fc1():
    """A block without D_fc2 is gated by its D_fc1, as in JAX."""
    rng = np.random.RandomState(0)
    tree = {"encoder": {"stages_0": {"blocks_0": {"adapter": {
        "D_fc1": {"kernel": rng.rand(4, 2).astype(np.float32),
                  "bias": rng.rand(2).astype(np.float32)}}}}}}
    sd = state_dict_from_jax(tree, {})
    block = "encoder.stages.0.blocks.0.adapter"
    assert A.adapter_block_paths(sd, "encoder") == [block]
    ref = state_dict_from_jax(
        JA.zero_adapter(tree, ("encoder", "stages_0", "blocks_0", "adapter")), {})
    got = A.zero_adapter(sd, block)
    for k in ref:
        assert torch.equal(got[k], ref[k]) and not got[k].any(), k


def test_ablation_lines_match_jax(trees, tmp_path):
    """run_block_ablation: one '<block> <abs_rel> <a1>' line per block in
    JAX's order, from an eval whose errors are the summed |D_fc2| and
    |D_fc1| of the weights it is given."""
    params, _, sd = trees

    def jax_eval(p):
        flat = traverse_util.flatten_dict(p)
        return [sum(float(np.abs(v).astype(np.float64).sum())
                    for k, v in flat.items() if layer in k)
                for layer in ("D_fc2",) * 4 + ("D_fc1",) * 3]

    def port_eval(s):
        return [sum(float(v.abs().double().sum()) for k, v in s.items()
                    if layer in k.split(".") and k.endswith(
                        ("weight", "bias")))
                for layer in ("D_fc2",) * 4 + ("D_fc1",) * 3]

    JA.run_block_ablation(jax_eval, params, SUBS, str(tmp_path / "jax.txt"))
    res = A.run_block_ablation(port_eval, sd, SUBS, str(tmp_path / "port.txt"))
    ref = (tmp_path / "jax.txt").read_text().splitlines()
    got = (tmp_path / "port.txt").read_text().splitlines()
    assert len(got) == len(ref) == len(res) == 20
    for g, r in zip(got, ref):
        name, *nums = r.split()
        jname = tuple(name.split("/"))
        assert g.split() == [torch_module_name(jname), *nums]


def test_evaluate_depth_layer_cli_on_cpu(trees, tmp_path, monkeypatch):
    """`python -m ppeadepth_tpu_torch.evaluate_depth_layer` on a synthetic
    KITTI split at the tiny model from a checkpoint of the drawn tree
    (non-zero D_fc2): 20 lines in repl.txt; gating a student
    (`encoder`) adapter moves the student's metrics, a teacher
    (`mono_encoder`) one leaves them as the unablated eval gives them,
    since the eval scores the student (as the JAX CLI's does)."""
    data, splits = kitti_set(tmp_path, 2, 2)
    (tmp_path / "ckpt").mkdir()
    torch.save(trees[2], str(tmp_path / "ckpt" / "model.pth"))
    monkeypatch.chdir(tmp_path)
    argv = ["--load_weights_folder", str(tmp_path / "ckpt"), "--data_path",
            data, "--rep_size", "t", "--adapter", "--height", "64", "--width",
            "96", "--split", "tiny", "--eval_split", "tiny", "--batch_size",
            "2", "--num_workers", "0"]
    res = evaluate_depth_layer.main(argv, device="cpu", splits_dir=splits)
    lines = (tmp_path / "repl.txt").read_text().splitlines()
    assert [ln.split()[0] for ln in lines] == [b for b, _ in res]
    assert len(lines) == 20
    eval_fn, sd = evaluate_depth_layer.make_eval_fn(
        parse_args(argv), "cpu", splits)
    base = eval_fn(sd)
    assert np.isfinite(base).all()
    for block, errors in res:
        if block.startswith("encoder."):
            assert not np.array_equal(errors, base), block
        else:
            np.testing.assert_array_equal(errors, base)


def test_convert_round_trip_into_a_session(trees, tmp_path):
    """A reference model.pth with a sibling track.pth becomes a checkpoint
    folder that an InferenceSession loads: the same depths as a session on
    the state_dict with the track's depth bins, teacher and student."""
    _, _, sd = trees
    ref_dir = tmp_path / "reference"
    ref_dir.mkdir()
    torch.save(sd, str(ref_dir / "model.pth"))
    torch.save({"min_depth_bin": 0.5, "max_depth_bin": 20.0},
               str(ref_dir / "track.pth"))
    out = convert.main(["--torch", str(ref_dir / "model.pth"), "--out",
                        str(tmp_path / "ckpt"), "--rep_size", "t",
                        "--height", "64", "--width", "96"])
    for f in ("model.pth", "track.json", "opt.json"):
        assert (tmp_path / "ckpt" / f).is_file()
    sess = InferenceSession(TINY, checkpoint=out, device="cpu", dtype="float32")
    want = InferenceSession(TINY, sd, device="cpu", dtype="float32",
                            min_depth_bin=0.5, max_depth_bin=20.0)
    assert (sess.min_depth_bin, sess.max_depth_bin) == (0.5, 20.0)
    rng = np.random.RandomState(1)
    img = rng.rand(1, 64, 96, 3).astype(np.float32)
    K = np.eye(4, dtype=np.float32)[None]
    K[0, 0, 0], K[0, 1, 1], K[0, 0, 2], K[0, 1, 2] = 13.92, 30.72, 12.0, 8.0
    lk = np.roll(img, 2, axis=2)
    np.testing.assert_array_equal(sess.predict_depth(img),
                                  want.predict_depth(img))
    np.testing.assert_array_equal(
        sess.predict_depth_multi(img, lk, K, np.linalg.inv(K)),
        want.predict_depth_multi(img, lk, K, np.linalg.inv(K)))
    # the flags override the track
    out2 = convert.main(["--torch", str(ref_dir / "model.pth"), "--out",
                         str(tmp_path / "ckpt2"), "--rep_size", "t",
                         "--min_depth_bin", "0.2", "--max_depth_bin", "30"])
    sess2 = InferenceSession(TINY, checkpoint=out2, device="cpu",
                             dtype="float32")
    assert (sess2.min_depth_bin, sess2.max_depth_bin) == (0.2, 30.0)
    # --no-adapter converts the adapter-free network
    out3 = convert.main(["--torch", str(ref_dir / "model.pth"), "--out",
                         str(tmp_path / "ckpt3"), "--rep_size", "t",
                         "--no-adapter"])
    with open(os.path.join(out3, "opt.json")) as f:
        assert json.load(f)["adapter"] is False
    plain = torch.load(os.path.join(out3, "model.pth"), weights_only=True)
    assert not any("adapter" in k.split(".") for k in plain)
    assert any("adapter" in k.split(".") for k in sd)


@pytest.mark.parametrize("matplotlib", [True, False],
                         ids=["plasma", "ramp"])
def test_colorize_matches_jax(matplotlib, monkeypatch):
    """colorize equals JAX's, with matplotlib's plasma and with the ramp
    both take without it."""
    if not matplotlib:
        monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    value = np.random.RandomState(2).rand(24, 40).astype(np.float32) * 7
    for kw in ({}, dict(vmin=1.0, vmax=5.0)):
        got = colorize(value, **kw)
        assert got.shape == (24, 40, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jax_colorize(value, **kw))
