"""The port's Trainer loop and CLI on the CPU at rep "t", 64x96, B=2 (no
JAX compile): one epoch over a synthetic KITTI set on disk with a
validation and checkpoints, `metrics.jsonl` under the JAX Trainer's keys,
an exact resume, the unported options raising, and the CLI refusing to
run without a card."""

import json
import os

import pytest
import torch

from ppeadepth_tpu.eval.metrics import METRIC_NAMES as JAX_METRIC_NAMES
from ppeadepth_tpu_torch.evaluate_depth import evaluate
from ppeadepth_tpu_torch.options import Config
from ppeadepth_tpu_torch.train import __main__ as cli
from ppeadepth_tpu_torch.train import trainer as trainer_mod
from ppeadepth_tpu_torch.train.trainer import Trainer
from tests.torch_parity import kitti_set
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

# the JAX train step's metrics (ppeadepth_tpu/train/step.py:324-331,
# :450-451), which its Trainer writes with "step" and "prefix"
JAX_TRAIN_KEYS = {"loss", "mono/loss", "mono/reproj", "multi/loss",
                  "multi/reproj", "multi/consistency", "depth_bins/min",
                  "depth_bins/max"}


def _opt(root, log_dir, **kw):
    return Config(weights_init="scratch", adapter=True, rep_size="t",
                  height=64, width=96, batch_size=2, num_depth_bins=8,
                  data_path=root, split="tiny", eval_split="tiny",
                  num_epochs=1, num_workers=2, validate_every=2,
                  log_dir=log_dir, name="smoke", **kw)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One epoch of 3 steps (6 items, B=2): a validation and a checkpoint
    at step 2, the final checkpoint, a metrics record every step."""
    tmp = tmp_path_factory.mktemp("trainer")
    root, splits = kitti_set(tmp, 6, 3)
    opt = _opt(root, str(tmp / "ckpt"))
    mp = pytest.MonkeyPatch()
    mp.setattr(trainer_mod, "LOG_EVERY", 1)
    try:
        trainer = Trainer(opt, splits_dir=splits, device="cpu")
        trainer.train()
        trainer.close()
    finally:
        mp.undo()
    return trainer, opt, splits


def test_trainer_runs_an_epoch(run):
    trainer, _, _ = run
    assert trainer.steps_per_epoch == 3 and trainer.state.step == 3
    for folder in ("smoke_s2", "smoke_final"):
        assert sorted(os.listdir(os.path.join(trainer.log_path, folder))) == [
            "adam.pth", "model.pth", "opt.json", "track.json"]
    with open(os.path.join(trainer.log_path, "smoke_final", "track.json")) as f:
        assert json.load(f)["step"] == 3


def test_metrics_jsonl_has_jax_keys(run):
    with open(os.path.join(run[0].log_path, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    by_prefix = {}
    for r in recs:
        by_prefix.setdefault(r.pop("prefix"), []).append(r)
    assert [r["step"] for r in by_prefix["train"]] == [1, 2, 3]
    assert all(set(r) == {"step"} | JAX_TRAIN_KEYS for r in by_prefix["train"])
    for prefix in ("val", "val_mono"):
        (rec,) = by_prefix[prefix]
        assert rec["step"] == 2 and set(rec) == {"step", *JAX_METRIC_NAMES}
    assert set(by_prefix) == {"train", "val", "val_mono"}


def test_resume_restores_state_exactly(run):
    trainer, opt, splits = run
    final = os.path.join(trainer.log_path, "smoke_final")
    resumed = Trainer(opt.replace(load_weights_folder=final, name="resume"),
                      splits_dir=splits, device="cpu")
    resumed.close()
    got = resumed.model.state_dict()
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(got[k], v), k
    ref, new = trainer.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert new["param_groups"] == ref["param_groups"] and ref["state"]
    for i, st in ref["state"].items():
        for k, v in st.items():
            assert torch.equal(new["state"][i][k], v), (i, k)
    assert resumed.scheduler.state_dict() == trainer.scheduler.state_dict()
    assert torch.equal(resumed.state.min_depth_bin, trainer.state.min_depth_bin)
    assert torch.equal(resumed.state.max_depth_bin, trainer.state.max_depth_bin)
    assert resumed.state.step == trainer.state.step == 3


@pytest.mark.parametrize("kw", [dict(grad_accum=2), dict(fast_pipeline=True),
                                dict(dc=True)])
def test_unported_options_raise(tmp_path, kw):
    with pytest.raises(NotImplementedError, match="not ported"):
        Trainer(_opt("", str(tmp_path), **kw), device="cpu")


def test_cli_needs_a_card(tmp_path, monkeypatch):
    """Without a CUDA device the CLI (training and --eval) raises; it does
    not carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--rep_size", "t", "--height", "64", "--width", "96",
            "--weights_init", "scratch", "--log_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate(Config(rep_size="t", height=64, width=96))
