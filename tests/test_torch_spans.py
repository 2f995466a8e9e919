"""The port's phase spans (`ppeadepth_tpu_torch.utils.trace.span`) on the
CPU at the tiny teacher's configuration: under a torch profiler the
session's requests and a training step give their `ppea:` ranges, nested
as the layers nest; with no profiler active no span calls into the
profiler; the Trainer counts the time it waits on its loader and prints
its share."""

import re
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ppeadepth_tpu_torch.models import RepDepth, init_weights
from ppeadepth_tpu_torch.options import Config
from ppeadepth_tpu_torch.serve import InferenceSession
from ppeadepth_tpu_torch.train import trainer as trainer_mod
from ppeadepth_tpu_torch.train.schedule import make_optimizer
from ppeadepth_tpu_torch.train.step import create_train_state, make_train_step
from ppeadepth_tpu_torch.utils import trace
from tests.torch_parity import TINY
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

B = 2
SERVE_TEACHER = {"serve.request", "serve.upload", "model.teacher_encoder",
                 "model.decoder", "serve.download"}
SERVE_STUDENT = {"serve.request", "serve.upload", "model.pose",
                 "model.student_encoder", "model.cost_volume", "model.decoder",
                 "serve.download"}
TRAIN = {"train.step", "model.pose", "model.teacher_encoder", "model.decoder",
         "model.student_encoder", "model.cost_volume", "train.losses",
         "train.backward", "train.allreduce", "train.optimizer", "train.bins"}


def _K(height, width):
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1] = 0.58 * width, 1.92 * height
    K[0, 2], K[1, 2] = 0.5 * width, 0.5 * height
    K = np.repeat(K[None], B, 0)
    return K, np.linalg.inv(K).astype(np.float32)


def _frames(rng, opt):
    base = rng.rand(B, opt.height, opt.width, 3).astype(np.float32)
    return {0: base, -1: np.roll(base, 2, 2), 1: np.roll(base, -2, 2)}


def _train_batch(rng, opt):
    out = {}
    for f, img in _frames(rng, opt).items():
        out[("color", f, 0)] = out[("color_aug", f, 0)] = img
    for sc in (0, 2):
        out[("K", sc)], out[("inv_K", sc)] = _K(opt.height >> sc, opt.width >> sc)
    return out


@pytest.fixture(scope="module")
def session():
    return InferenceSession(TINY, device="cpu", dtype="float32")


@pytest.fixture(scope="module")
def step():
    opt = TINY.replace(drop_path_rate=0.0)
    model = RepDepth(opt)
    init_weights(model, torch.Generator().manual_seed(0))
    state = create_train_state(model, opt, device="cpu")
    optim, sched = make_optimizer(
        [p for p in model.parameters() if p.requires_grad], 1e-4, 10)
    return make_train_step(model, opt, optim, sched), state, opt


def _serve(session, rng):
    frames = _frames(rng, TINY)
    session.predict_depth(frames[0])
    K, invK = _K(TINY.height // 4, TINY.width // 4)
    session.predict_depth_multi(frames[0], frames[-1], K, invK)


def _ranges(prof):
    """The profile's `ppea:` ranges as (name, start_ns, end_ns), by start."""
    return sorted(((e.name()[len(trace.PREFIX):], e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(trace.PREFIX)), key=lambda r: r[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_serve_spans_nest(session):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(session, np.random.RandomState(0))
    got = _ranges(prof)
    requests = [r for r in got if r[0] == "serve.request"]
    assert len(requests) == 2
    teacher, student = ([r for r in got if _inside(r, q)] for q in requests)
    assert {r[0] for r in teacher} == SERVE_TEACHER
    assert {r[0] for r in student} == SERVE_STUDENT
    assert len(teacher) + len(student) == len(got)
    (cv,) = [r for r in student if r[0] == "model.cost_volume"]
    (enc,) = [r for r in student if r[0] == "model.student_encoder"]
    assert _inside(cv, enc)


def test_train_step_spans_nest(step):
    train_step, state, opt = step
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        new_state, _ = train_step(state, _train_batch(np.random.RandomState(1), opt))
    got = _ranges(prof)
    (outer,) = [r for r in got if r[0] == "train.step"]
    assert all(_inside(r, outer) for r in got)
    assert {r[0] for r in got} == TRAIN
    cv = [r for r in got if r[0] == "model.cost_volume"]
    enc = [r for r in got if r[0] == "model.student_encoder"]
    assert len(cv) == len(enc) == 1 and _inside(cv[0], enc[0])
    assert new_state.step == state.step + 1


def test_no_profiler_no_record_function(session, step, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler active")

    monkeypatch.setattr(trace, "record_function", refuse)
    assert trace.span("serve.request") is trace.span("model.pose")
    _serve(session, np.random.RandomState(2))
    train_step, state, opt = step
    train_step(state, _train_batch(np.random.RandomState(3), opt))


class _SleepyLoader:
    """Two training batches, each after a nap."""

    def __init__(self, opt, nap):
        self.opt, self.nap = opt, nap

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        rng = np.random.RandomState(4)
        for _ in range(2):
            time.sleep(self.nap)
            yield _train_batch(rng, self.opt)


def test_trainer_counts_loader_wait(tmp_path, monkeypatch, capsys):
    opt = Config(weights_init="scratch", adapter=True, rep_size="t", height=64,
                 width=96, batch_size=B, num_depth_bins=8, num_epochs=1,
                 validate_every=0, drop_path_rate=0.0, log_dir=str(tmp_path),
                 name="spans")
    monkeypatch.setattr(trainer_mod, "LOG_EVERY", 1)
    trainer = trainer_mod.Trainer(opt, device="cpu")
    trainer.train_loader = _SleepyLoader(trainer.opt, 0.2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train()
    trainer.close()
    shares = [float(s) for s in re.findall(r"loader wait ([0-9.]+) %",
                                           capsys.readouterr().out)]
    assert len(shares) == 2 and shares[0] > 0
    assert trainer.loader_wait_s >= 0.2
    names = [r[0] for r in _ranges(prof)]
    assert names.count("train.loader_wait") == 3  # two batches and the end
    assert names.count("train.step") == 2


def test_chip_smoke_phase_times_merge_device_copies():
    """`chip_smoke.py --profile`'s phase line: host ranges summed, a
    range's overlapping device-side copies (one a stream) counted once,
    and only the kernel time inside them taken as busy."""
    import chip_smoke

    kernels = [(0, 10), (12, 20), (18, 30), (40, 50)]
    host = [(0, 25), (35, 45)]
    device = [(5, 22), (15, 28), (42, 60)]
    assert chip_smoke._union_us(kernels) == 10 + 18 + 10
    assert chip_smoke._phase_us(host, device, kernels) == (
        25 + 10, (28 - 5) + (60 - 42), (10 - 5) + (28 - 12) + (50 - 42))
