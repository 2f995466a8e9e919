"""Find a cell's pieces by name: BENCHMARK.json at the checkout's root,
`configs/<config>.json`, `traffic/<traffic>.json`, the mix's loop
`loops/<kind>.py`, `limits/<workload>.json`, `metrics/<metric>.py` and
`roofline/<kernel>.py` under the benchmark's folder. Adding a cell or a
metric adds files; no file here changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    """`<kind>/<name>.py` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(workload: str, bench: dict | None = None) -> dict:
    """Everything one run needs: the workload entry, its configuration
    and traffic files, its limits, and its metrics by kind."""
    bench = bench or manifest()
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]

    def mine(m):
        return workload in m.get("workloads", [workload])

    return {
        "workload": w,
        "config": _json("configs", w["config"]),
        "traffic": _json("traffic", w["traffic"]),
        "limits": _json("limits", workload),
        "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
        "per_layer": [m for m in bench["per_layer"] if mine(m)],
    }
