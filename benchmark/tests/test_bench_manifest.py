"""BENCHMARK.json against the benchmark's contract and its files, and the
import guard: nothing under benchmark/ imports JAX or the JAX package
(top-level module names compared whole), and the reference imports
nothing of the measured program."""

import ast
import json
import re

import pytest

from bench_tiny import HELD, bench_with_held
from harness import cells, guard
from reference import nets

BENCH = cells.HERE
MANIFEST = cells.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_imports(path):
    found = _imports(path)
    assert not found & set(guard.FORBIDDEN), path
    if "reference" in path.relative_to(BENCH).parts:
        assert not found & {"ppeadepth_tpu_torch", "harness", "run"}, path
        assert found <= {"__future__", "math", "numpy", "torch"}, found
    # no file of the JAX package's benchmark, nor chip_smoke, is opened
    strings = {n.value for n in ast.walk(ast.parse(path.read_text()))
               if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    for old in ("bench" + ".py", "BENCH" + "_r", "MULTICHIP" + "_r", "chip" + "_smoke"):
        assert not any(s.startswith(old) for s in strings), (path, old)


def test_guard_compares_whole_top_level_names():
    mods = {"ppeadepth_tpu_torch.serve": 1, "jaxtyping": 1, "flax.linen": 1,
            "numpy": 1, "ppeadepth_tpu": 1}
    assert guard.jax_modules(mods) == ["flax", "ppeadepth_tpu"]


def test_names_units_and_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(MANIFEST)) < 64 * 1024
    names = [c["name"] for c in MANIFEST["configs"]]
    names += [w["name"] for w in MANIFEST["workloads"]]
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    names += [m["name"] for m in metrics]
    names += [w[k] for w in MANIFEST["workloads"] for k in ("config", "traffic")]
    for n in names:
        assert NAME.match(n), n
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in MANIFEST["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and w["chips"] in (1, 4)


def _reports(workload):
    return {m["name"] for m in bench_with_held()["end_to_end"]
            if workload in m.get("workloads", [workload])}


@pytest.mark.parametrize("w", MANIFEST["workloads"] + HELD["workloads"],
                         ids=lambda w: w["name"])
def test_cell_resolves_to_files(w):
    cell = cells.cell(w["name"], bench_with_held())
    loop = cells.load_module("loops", cell["traffic"]["kind"]).Loop
    assert callable(loop.unit) and callable(loop.passes)
    assert cell["traffic"]["traced"] >= 1
    assert "setup_s" in _reports(w["name"]) and len(_reports(w["name"])) >= 2
    assert cell["per_layer"], w["name"]
    assert set(cell["limits"]) and all(v > 0 for v in cell["limits"].values())


@pytest.mark.parametrize("m", MANIFEST["per_layer"] + HELD["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_reader_and_moves(m):
    assert callable(cells.load_module("metrics", m["name"]).read)
    for w in m["workloads"]:
        assert m["moves"] in _reports(w), (m["name"], w)


@pytest.mark.parametrize("c", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    path = cells.ROOT / c["file"]
    assert path.is_relative_to(BENCH)
    cfg = json.loads(path.read_text())
    assert cfg["name"] == c["name"] and c["reduced"] == []
    o, arch = cfg["options"], nets.REPLK[cfg["options"]["rep_size"]]
    assert cfg["model"]["channels"] == list(arch["channels"])
    assert cfg["model"]["layers"] == list(arch["layers"])
    assert cfg["model"]["large_kernels"] == list(arch["kernels"])
    assert cfg["model"]["depth_bins"] == o["num_depth_bins"]


def test_paths_and_command():
    assert MANIFEST["paths"] == ["benchmark"]
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert not any(p.name.endswith("_torch") for p in [BENCH])
