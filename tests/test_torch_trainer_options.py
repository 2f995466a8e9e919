"""The port's Trainer on the CPU at rep "t", 64x96, B=2 (no JAX compile):
an epoch under `--grad_accum 2` and one under `--fast_pipeline
--decode_cache` on a synthetic KITTI set, and the CLI refusing to run
without a card. Split from tests/test_torch_trainer.py (the epoch, resume
and stage 2), so that every port test file stays behind
tests/test_train_step.py in pytest-xdist's file queue."""

import json
import os

import pytest
import torch

from ppeadepth_tpu_torch.evaluate_depth import evaluate
from ppeadepth_tpu_torch.options import Config
from ppeadepth_tpu_torch.train import __main__ as cli
from ppeadepth_tpu_torch.train import trainer as trainer_mod
from ppeadepth_tpu_torch.train.trainer import Trainer
from tests.test_torch_trainer import JAX_TRAIN_KEYS, _opt
from tests.torch_parity import kitti_set
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("kw", [dict(grad_accum=2), dict(fast_pipeline=True)],
                         ids=["grad_accum", "fast_pipeline"])
def test_trainer_epoch_under_option(tmp_path, kw, monkeypatch):
    """An epoch of 3 full-batch steps (B=2) under --grad_accum 2 or
    --fast_pipeline --decode_cache: a metrics record under the JAX keys
    each step, finite, and the final checkpoint at step 3; the fast
    pipeline's decode cache written."""
    root, splits = kitti_set(tmp_path, 6, 3)
    cache = str(tmp_path / "cache")
    opt = _opt(root, str(tmp_path / "ckpt"), **kw).replace(
        validate_every=0, decode_cache=cache if kw.get("fast_pipeline") else "")
    monkeypatch.setattr(trainer_mod, "LOG_EVERY", 1)
    trainer = Trainer(opt, splits_dir=splits, device="cpu")
    try:
        assert trainer.steps_per_epoch == 3
        trainer.train()
    finally:
        trainer.close()
    assert trainer.state.step == 3
    with open(os.path.join(trainer.log_path, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r.pop("prefix") for r in recs] == ["train"] * 3
    assert [r["step"] for r in recs] == [1, 2, 3]
    for r in recs:
        assert set(r) == {"step"} | JAX_TRAIN_KEYS
        assert all(v == v and abs(v) < 1e6 for v in r.values())
    with open(os.path.join(trainer.log_path, "smoke_final", "track.json")) as f:
        assert json.load(f)["step"] == 3
    if kw.get("fast_pipeline"):
        names = os.listdir(cache)
        assert any(n.endswith(".u8") for n in names)
        (present,) = [n for n in names if n.endswith(".present")]
        with open(os.path.join(cache, present), "rb") as f:
            assert all(f.read())  # every frame of the epoch decoded once


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
