"""The port's Trainer loop and CLI on the CPU at rep "t", 64x96, B=2 (no
JAX compile): one epoch over a synthetic KITTI set on disk with a
validation and checkpoints, `metrics.jsonl` under the JAX Trainer's keys,
an exact resume, stage 2 (`--train_cs --dc --ktf` from that stage-1
checkpoint, on a synthetic CityScapes set with its `cityscapes_eval`
validation, and `--eval --eval_split cityscapes`), the unported options
raising, and the CLI refusing to run without a card."""

import json
import os

import pytest
import torch

from ppeadepth_tpu.eval.metrics import METRIC_NAMES as JAX_METRIC_NAMES
from ppeadepth_tpu_torch.eval import evaluator
from ppeadepth_tpu_torch.evaluate_depth import evaluate
from ppeadepth_tpu_torch.options import Config
from ppeadepth_tpu_torch.train import __main__ as cli
from ppeadepth_tpu_torch.train import trainer as trainer_mod
from ppeadepth_tpu_torch.train.trainer import Trainer
from tests.torch_parity import cityscapes_set, kitti_set
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


@pytest.fixture(scope="module")
def stage2(run, tmp_path_factory):
    """Stage 2 on the CPU: `--train_cs --dc --dec_id 1 --ktf
    --learning_rate 1e-5` from the stage-1 run's final checkpoint (its
    track.json step is 3), one epoch of 2 steps (4 items, B=2) on a
    synthetic CityScapes set with a validation on its `cityscapes_eval`
    layout at step 2. Returns (trainer, its parameters before training,
    opt, splits_dir, stage-1 trainer)."""
    stage1 = run[0]
    tmp = tmp_path_factory.mktemp("stage2")
    train, ev, splits = cityscapes_set(tmp, 4, 3)
    opt = _opt(train, str(tmp / "ckpt"), train_cs=True, dc=True, dec_id=1,
               ktf=True, learning_rate=1e-5, cs_eval_path=ev,
               load_weights_folder=os.path.join(stage1.log_path, "smoke_final"))
    opt = opt.replace(name="cs")
    mp = pytest.MonkeyPatch()
    mp.setattr(trainer_mod, "LOG_EVERY", 1)
    try:
        trainer = Trainer(opt, splits_dir=splits, device="cpu")
        before = {n: p.detach().clone()
                  for n, p in trainer.model.named_parameters()}
        assert trainer.state.step == 0
        trainer.train()
        trainer.close()
    finally:
        mp.undo()
    return trainer, before, opt, splits, stage1


def test_stage2_ktf_starts_at_step_0(stage2):
    """--ktf is a warm start into a new run: the stage-1 weights, BN
    statistics and depth bins, step 0 (not track.json's 3) and a fresh
    Adam; every step of the epoch runs; the CityScapes preset holds."""
    trainer, before, _, _, stage1 = stage2
    assert trainer.opt.dataset == "cityscapes_preprocessed"
    assert (trainer.opt.height, trainer.opt.width) == (64, 96)
    assert trainer.steps_per_epoch == 2 and trainer.state.step == 2
    s1 = stage1.model.state_dict()
    for n, p in before.items():
        if "adapter" in n.split(".")[1] or "deconv_adpt" in n:
            if n.split(".")[0] in ("depth", "mono_depth") and "D_fc1" not in n:
                assert p.abs().max() == 0, n  # stage-2 adapters start at zero
        else:
            assert torch.equal(p, s1[n]), n
    with open(os.path.join(trainer.log_path, "cs_final", "track.json")) as f:
        assert json.load(f)["step"] == 2
    with open(os.path.join(stage1.log_path, "smoke_final", "track.json")) as f:
        assert json.load(f)["step"] == 3
    adam = torch.load(os.path.join(trainer.log_path, "cs_final", "adam.pth"),
                      weights_only=True)
    assert all(int(st["step"]) == 2 for st in adam["optimizer"]["state"].values())


def test_stage2_freezes_all_but_adapters(stage2):
    """Frozen parameters, the decoder trunks and heads among them, are
    bit-identical after the epoch; in each decoder only `adapter` and
    `deconv_adpt` train, and they moved. From a stage-1 model both start at
    zero (D_fc2 and the deconv kernel), so each passes the other a zero
    gradient, and `deconv_adpt.bias` is what the first steps move, as in
    the JAX package; the encoders' adapters moved too."""
    trainer, before, _, _, _ = stage2
    named = dict(trainer.model.named_parameters())
    frozen = [n for n, p in named.items() if not p.requires_grad]
    assert any(n.startswith(("depth.upconvs", "mono_depth.disp_convs"))
               for n in frozen)
    for n in frozen:
        assert torch.equal(named[n], before[n]), n
    moved = {n for n, p in named.items() if not torch.equal(p, before[n])}
    for dec in ("depth", "mono_depth"):
        trained = [n for n, p in named.items()
                   if n.startswith(dec + ".") and p.requires_grad]
        assert {n.split(".")[1] for n in trained} == {"adapter", "deconv_adpt"}
        assert f"{dec}.deconv_adpt.bias" in moved
    for enc in ("encoder", "mono_encoder"):
        assert any(n.startswith(enc + ".") and "adapter" in n for n in moved)


def test_stage2_validates_on_cityscapes_eval(stage2):
    """The validation set is the `cityscapes_eval` layout under
    --cs_eval_path, and its metrics records (student and teacher, at step
    2) are finite."""
    trainer, _, opt, _, _ = stage2
    ds = trainer.val_loader.dataset
    assert type(ds).__name__ == "CityscapesEvalDataset"
    assert ds.data_path == opt.cs_eval_path
    with open(os.path.join(trainer.log_path, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    for prefix in ("val", "val_mono"):
        (rec,) = [r for r in recs if r["prefix"] == prefix]
        assert rec["step"] == 2
        assert all(v == v and abs(v) < float("inf") for v in rec.values()
                   if isinstance(v, float))


def test_stage2_checkpoint_round_trips(stage2):
    """A plain resume from stage 2's final checkpoint restores its weights
    and step exactly, and `--eval --eval_split cityscapes` on it gives
    finite metrics for student and teacher."""
    trainer, _, opt, splits, _ = stage2
    final = os.path.join(trainer.log_path, "cs_final")
    resumed = Trainer(opt.replace(load_weights_folder=final, ktf=False,
                                  name="cs_resume"),
                      splits_dir=splits, device="cpu")
    resumed.close()
    got = resumed.model.state_dict()
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(got[k], v), k
    assert resumed.state.step == 2
    errors, mono = evaluate(opt.replace(load_weights_folder=final, ktf=False,
                                        eval_teacher=True),
                            device="cpu", splits_dir=splits)
    assert len(errors) == len(mono) == 7
    assert all(e == e for e in (*errors, *mono))


@pytest.mark.parametrize("kw", [dict(grad_accum=2), dict(fast_pipeline=True)])
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


@pytest.mark.parametrize("entry", ["evaluate", "validate"])
def test_eval_pass_runs_without_tf32(run, monkeypatch, entry):
    """The eval's device pass (`evaluate`, `Trainer.validate`) runs with
    cuDNN TF32 off, as the JAX eval computes f32 convs, and the caller's
    flag is the same after it as before."""
    trainer, opt, splits = run
    seen = []
    run_eval = evaluator.run_eval

    def spy(*a, **kw):
        seen.append(torch.backends.cudnn.allow_tf32)
        return run_eval(*a, **kw)

    monkeypatch.setattr(evaluator, "run_eval", spy)
    monkeypatch.setattr(trainer, "log_metrics", lambda *a, **kw: None)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    if entry == "evaluate":
        final = os.path.join(trainer.log_path, "smoke_final")
        evaluate(opt.replace(load_weights_folder=final), device="cpu",
                 splits_dir=splits)
    else:
        trainer.validate(trainer.state.step)
    assert seen == [False]
    assert torch.backends.cudnn.allow_tf32 is True
