"""On a card (`-m gpu`; skipped without one): one short run of a cell is
correct, and the control, the reference with float8 operands in the
program's place, fails the cell's limits at the cell's own size."""

import pytest

import calibrate
import run
from harness import cells, check, program

SEED = 5_000_000_017


@pytest.mark.gpu
def test_serve_cell_runs(cuda):
    out, _ = run.run_cell("kitti-serve-student-b32", SEED, 3.0, False)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["attempted"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in cells.manifest()["workloads"]])
def test_control_fails_at_cell_size(cuda, workload):
    cell = cells.cell(workload)
    fn = (calibrate.train_readings if cell["traffic"]["kind"] == "train_steps"
          else calibrate.serve_readings)
    got = fn(program.port(), cell, SEED, "cuda", control=True, fault=False)
    assert check.verdict(got["sound"], cell["limits"])[0], got["sound"]
    assert not check.verdict(got["control"], cell["limits"])[0], got["control"]
