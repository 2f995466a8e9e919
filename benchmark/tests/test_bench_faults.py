"""A whole run of each cell, cut to a tiny size on the CPU (the run's look
for a chip skipped), comes out correct; with the timed path broken
underneath it comes out not correct, once for each fault a cell can
have: a training step that leaves its state unchanged, a step on half
of the batch with the mean taken over the rest, a served answer altered
where it is produced; and with the control, the reference computed with
float8 operands, in the program's place. (The cells run on one chip, so
no exchange between chips can be left out.)

The program computes in float32 here, so a sound run reads far under the
limits set for its bf16 runs on the card."""

import pytest

import calibrate
import run
from bench_tiny import tiny_cell
from harness import check, program

SEED = 31337
TRAIN = ["kitti-train-b12", "cs-dc-train-b12"]
SERVE = ["kitti-serve-student-b32", "cs-dc-serve-teacher-b32"]


@pytest.fixture(scope="module")
def port():
    return program.port()


def _run(workload, patch=None, **options):
    cell = tiny_cell(workload, **options)
    out, lines = run.run_cell(workload, SEED, 0.3, False, device="cpu",
                              cell=cell, patch=patch)
    assert len(lines) == len(cell["limits"]) + 1
    return out


@pytest.mark.parametrize("workload", TRAIN)
def test_train_sound(workload):
    out = _run(workload, compute_dtype="float32")
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and set(out["metrics"]) == {
        "train_img_s", "train_peak_gib", "setup_s"}


@pytest.mark.parametrize("workload", TRAIN)
def test_train_state_unchanged(workload):
    def frozen(loop):
        loop.optim.step = lambda *a, **k: None
    out = _run(workload, frozen, compute_dtype="float32")
    assert not out["correct"]
    # each leaf reads |0 - r| / max(r, median r): the median leaf about 1
    assert out["checks"]["update_gap"]["value"] == pytest.approx(1.0, abs=0.01)


@pytest.mark.parametrize("workload", TRAIN)
def test_train_half_batch(workload):
    out = _run(workload, calibrate._half, compute_dtype="float32")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", SERVE)
def test_serve_sound(workload):
    out = _run(workload, serve_dtype="float32")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"serve_img_s", "serve_p95_ms", "setup_s"}


@pytest.mark.parametrize("workload", SERVE)
def test_serve_answer_altered(workload):
    def altered(loop):
        fn = loop.fn

        def wrong(*request):
            depth = fn(*request).copy()
            depth[0, : depth.shape[1] // 8] *= 1.5  # one image's top rows
            return depth
        loop.fn = wrong
    out = _run(workload, altered, serve_dtype="float32")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", TRAIN + SERVE)
def test_control_fails(port, workload):
    """The control fails the cell's limits; serving at the cell's own
    widths (64x96, B=2; the "t" widths' errors are far smaller than the
    36-block network's), where the program's bf16 forward still passes."""
    if workload in TRAIN:
        cell, fn = tiny_cell(workload), calibrate.train_readings
    else:
        cell, fn = tiny_cell(workload, widths="b"), calibrate.serve_readings
    got = fn(port, cell, SEED, "cpu", control=True, fault=False)
    assert not check.verdict(got["control"], cell["limits"])[0], got
    if workload in SERVE:
        assert check.verdict(got["sound"], cell["limits"])[0], got
