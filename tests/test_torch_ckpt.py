"""The port's checkpoints (`ckpt.io`, the reference's model.pth / adam.pth
/ track.json / opt.json) and ImageNet bootstrap (`ckpt.pretrained`): an
exact save/load round trip; the JAX package's torch importer reads the
port's model.pth back to the same tensors; the bootstrap loads what the
JAX `bootstrap_pretrained` loads from the same synthetic release files;
`InferenceSession` serves from a reference model.pth and from a
checkpoint folder as from a state_dict. No JAX compile (the JAX trees
are drawn with jax.eval_shape and numpy)."""

import json
import os

import numpy as np
import pytest
import torch

from ppeadepth_tpu.ckpt import torch_import as TI
from ppeadepth_tpu_torch.ckpt import io as ckpt_io
from ppeadepth_tpu_torch.ckpt.convert import state_dict_from_jax
from ppeadepth_tpu_torch.ckpt.pretrained import (
    REPLK_IMAGENET_FILES, bootstrap_pretrained)
from ppeadepth_tpu_torch.models import RepDepth, init_weights
from ppeadepth_tpu_torch.options import Config
from ppeadepth_tpu_torch.serve import InferenceSession
from ppeadepth_tpu_torch.train.schedule import make_optimizer
from ppeadepth_tpu_torch.train.step import create_train_state, make_train_step
from tests.test_train_step import make_batch
from tests.torch_parity import TINY, jax_repdepth
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

OPT = Config(adapter=True, rep_size="t", height=64, width=96,
             drop_path_rate=0.0)


def _model():
    model = RepDepth(OPT)
    model.load_state_dict(state_dict_from_jax(*jax_repdepth()), strict=True)
    return model


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A model, optimizer, scheduler and state after one training step,
    saved as a checkpoint folder; returns them and the folder (shared:
    tests do not change them)."""
    tmp_path = tmp_path_factory.mktemp("trained")
    model = _model()
    state = create_train_state(model, OPT, device="cpu")
    optim, sched = make_optimizer(
        [p for p in model.parameters() if p.requires_grad], 1e-4, 10)
    batch = {k: np.asarray(v) for k, v in make_batch(OPT, 2).items()}
    state, _ = make_train_step(model, OPT, optim, sched)(state, batch)
    folder = str(tmp_path / "ckpt")
    ckpt_io.save_checkpoint(folder, model, optim, sched, state, OPT)
    return model, optim, sched, state, folder


def test_checkpoint_round_trip_exact(trained):
    """Parameters, BN statistics, Adam's moments and step counts, the
    schedule, the depth bins and the step come back bit for bit."""
    model, optim, sched, state, folder = trained
    assert sorted(os.listdir(folder)) == ["adam.pth", "model.pth", "opt.json",
                                          "track.json"]
    fresh = RepDepth(OPT)
    init_weights(fresh, torch.Generator().manual_seed(1))
    create_train_state(fresh, OPT, device="cpu")
    optim2, sched2 = make_optimizer(
        [p for p in fresh.parameters() if p.requires_grad], 1e-4, 10)
    track = ckpt_io.load_model(folder, fresh)
    assert ckpt_io.load_adam(folder, optim2, sched2)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    ref, got = optim.state_dict(), optim2.state_dict()
    assert got["param_groups"] == ref["param_groups"]
    assert set(got["state"]) == set(ref["state"]) and ref["state"]
    for i, st in ref["state"].items():
        for k, v in st.items():
            assert torch.equal(got["state"][i][k], v), (i, k)
    assert sched2.state_dict() == sched.state_dict()
    assert track == {"height": 64, "width": 96,
                     "min_depth_bin": state.min_depth_bin.item(),
                     "max_depth_bin": state.max_depth_bin.item(), "step": 1}
    assert track["max_depth_bin"] != 10.0  # the EMA moved
    with open(os.path.join(folder, "opt.json")) as f:
        assert json.load(f)["rep_size"] == "t"


def test_load_model_merges_and_adam_falls_back(tmp_path, capsys):
    """A model.pth missing an entry and holding an unknown one loads the
    rest and reports both; an adam.pth of another parameter set, or none,
    leaves the optimizer fresh with a message."""
    model = _model()
    sd = model.state_dict()
    name = "mono_depth.disp_convs.0.conv.bias"
    folder = tmp_path / "partial"
    folder.mkdir()
    torch.save({**{k: v for k, v in sd.items() if k != name},
                "head.weight": torch.zeros(3)}, str(folder / "model.pth"))
    fresh = RepDepth(OPT)
    init_weights(fresh, torch.Generator().manual_seed(1))
    before = fresh.state_dict()[name].clone()
    assert ckpt_io.load_model(str(folder), fresh) == {}
    assert "1 missing, 1 unexpected" in capsys.readouterr().out
    got = fresh.state_dict()
    assert torch.equal(got[name], before)
    assert all(torch.equal(got[k], v) for k, v in sd.items() if k != name)

    params = [p for p in fresh.parameters()][:3]
    optim, sched = make_optimizer(params, 1e-4, 10)
    assert not ckpt_io.load_adam(str(folder), optim, sched)
    torch.save({"optimizer": {"state": {}, "param_groups": []},
                "scheduler": sched.state_dict()}, str(folder / "adam.pth"))
    assert not ckpt_io.load_adam(str(folder), optim, sched)
    out = capsys.readouterr().out
    assert "no " in out and "could not restore" in out


def test_jax_importer_reads_model_pth(trained):
    """`torch_import.load_torch_repdepth` maps every entry of the port's
    model.pth onto the JAX trees; converted back they equal the saved
    tensors exactly (BN's num_batches_tracked has no JAX counterpart)."""
    folder = trained[-1]
    params, stats = jax_repdepth()
    p, s, loaded, missing = TI.load_torch_repdepth(
        os.path.join(folder, "model.pth"), params, stats, verbose=False)
    assert missing == [] and loaded > 0
    back = state_dict_from_jax(p, s)
    saved = torch.load(os.path.join(folder, "model.pth"), weights_only=True)
    assert set(back) == {k for k in saved if not k.endswith("num_batches_tracked")}
    for k, v in back.items():
        assert torch.equal(v, saved[k]), k


def test_bootstrap_matches_jax(tmp_path):
    """The port's `bootstrap_pretrained` against the JAX one on synthetic
    release files: a RepLKNet state_dict under the ImageNet names (no
    adapters, plus a classifier head) and a torchvision resnet18 one
    (1-image stem, plus fc), both random. Every tensor equal."""
    rng = np.random.RandomState(3)
    params, stats = jax_repdepth()
    ref_model = _model()

    def rand(sd, skip=()):
        return {k: torch.from_numpy(rng.rand(*v.shape).astype(np.float32))
                if v.is_floating_point() else v
                for k, v in sd.items() if not any(s in k for s in skip)}

    replk = rand(ref_model.mono_encoder.state_dict(), ("adpt", "adapter"))
    replk["head.weight"] = torch.zeros(10, 128)
    pose = rand(ref_model.pose_encoder.encoder.state_dict())
    pose["conv1.weight"] = torch.from_numpy(
        rng.rand(64, 3, 7, 7).astype(np.float32))
    pose["fc.weight"] = torch.zeros(1000, 512)
    torch.save({"model": replk}, str(tmp_path / REPLK_IMAGENET_FILES.get(
        "t", "RepLKNet-t.pth")))
    torch.save(pose, str(tmp_path / "resnet18-f37072fd.pth"))

    jopt = TINY.replace(backbone_weights=str(tmp_path))
    out = TI.bootstrap_pretrained({"params": params, "batch_stats": stats},
                                  jopt, verbose=False)
    ref = state_dict_from_jax(out["params"], out["batch_stats"])
    bootstrap_pretrained(ref_model, OPT.replace(backbone_weights=str(tmp_path)),
                         verbose=False)
    got = ref_model.state_dict()
    init = state_dict_from_jax(params, stats)
    changed = 0
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
        changed += not torch.equal(v, init[k])
    assert changed > 100
    inflated = got["pose_encoder.encoder.conv1.weight"]
    assert torch.equal(inflated[:, 3:], pose["conv1.weight"] / 2)


def test_bootstrap_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="--weights_init scratch"):
        bootstrap_pretrained(_model(), OPT.replace(backbone_weights=str(tmp_path)))


def test_session_from_checkpoints_equals_state_dict(trained):
    """`InferenceSession(torch_checkpoint=model.pth)` and
    `(checkpoint=folder)` serve exactly what `(state_dict=...)` serves;
    the folder's track.json sets the depth bins."""
    model, _, _, state, folder = trained
    sd = model.state_dict()
    images = np.random.RandomState(4).rand(2, 64, 96, 3).astype(np.float32)
    kw = dict(device="cpu", dtype="float32")
    sessions = [InferenceSession(OPT, sd, **kw),
                InferenceSession(OPT, torch_checkpoint=os.path.join(
                    folder, "model.pth"), **kw),
                InferenceSession(OPT, checkpoint=folder, **kw)]
    ref = sessions[0].predict_depth(images)
    for sess in sessions[1:]:
        np.testing.assert_array_equal(sess.predict_depth(images), ref)
    assert sessions[2].min_depth_bin == state.min_depth_bin.item()
    assert sessions[2].max_depth_bin == state.max_depth_bin.item()
    assert sessions[1].max_depth_bin == 10.0
    with pytest.raises(ValueError, match="at most one"):
        InferenceSession(OPT, sd, checkpoint=folder, **kw)
