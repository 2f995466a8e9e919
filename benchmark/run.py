#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of BENCHMARK.json's `workloads`; its configuration,
traffic mix, the mix's loop, limits and per-layer readers are files under
this folder, found by name (`harness/cells.py`). The run builds or loads
the program's kernels, makes the weights and inputs on the card from the
seed, warms up the cell's shapes, measures for --seconds, with --trace 1
profiles the mix's `traced` units after the window, checks the outputs
against the plain reference, and prints one JSON line last on standard
output.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import cells, check, guard, model_pass, program, trace, weights  # noqa: E402
from harness.layers import Context  # noqa: E402


def _fmt(v):
    return "none" if v is None else f"{v:.6g}"


def _cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def _sync(device):
    if _cuda(device):
        torch.cuda.synchronize(device)


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _traced(loop, n, device, counts):
    from torch.profiler import ProfilerActivity, profile, record_function

    before = dict(counts)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if _cuda(device) else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            with record_function(trace.SPAN + loop.unit_name):
                loop.unit()
        with record_function(trace.SPAN + "synchronize"):
            _sync(device)
        window = time.perf_counter() - t0
    device_ev, host_ev = trace.events(prof)
    return trace.Summary(device_ev, host_ev, window, n,
                         {k: counts[k] - before[k] for k in counts})


def make_loop(port, cell, sd, seed, device):
    """The mix's loop, `loops/<kind>.py`."""
    kind = cell["traffic"]["kind"]
    return cells.load_module("loops", kind).Loop(port, cell, sd, seed, device)


def run_cell(workload, seed, seconds, trace_on, *, device="cuda", cell=None,
             patch=None):
    """One run; returns (result dict, check lines). `cell` and `patch`
    (a callable given the loop after set-up) serve the CPU tests."""
    cell = cell or cells.cell(workload)
    mix = cell["traffic"]
    marks = [("imports", time.perf_counter())]
    port = program.port()
    if _cuda(device):
        port["kernels"].build.library()  # from build/kernels/, built once
    marks.append(("kernels", time.perf_counter()))
    sd = weights.state_dict(cell["config"], program.sub_seed(seed, 0), device)
    marks.append(("weights", time.perf_counter()))
    loop = make_loop(port, cell, sd, seed, device)
    if patch is not None:
        patch(loop)
    marks.append(("program", time.perf_counter()))
    loop.warm_up(mix["check"])
    _sync(device)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - T_START
    parts, last = [], T_START
    for name, t in marks:
        parts.append(f"{name} {t - last:.2f} s")
        last = t
    setup_peak = torch.cuda.max_memory_allocated(device) if _cuda(device) else 0

    # the device's memory in use is the window's: reset once set-up is done
    if _cuda(device):
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    n, stamps = 0, []
    while True:
        loop.unit()
        n += 1
        stamps.append(time.perf_counter() - t0)
        if stamps[-1] >= seconds:
            break
    _sync(device)
    window = time.perf_counter() - t0
    fifths = np.histogram(stamps, bins=5, range=(0, max(stamps[-1], 1e-9)))[0]
    peak = torch.cuda.max_memory_allocated(device) if _cuda(device) else 0
    e2e = loop.end_to_end(n, window, peak)
    e2e["setup_s"] = (setup_s, "s")

    dev_info = {"platform": "gpu" if _cuda(device) else "cpu",
                "kind": torch.cuda.get_device_name(device) if _cuda(device) else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    result = {}
    if trace_on:
        summary = _traced(loop, mix["traced"], device, port["kernels"].launch_counts)
        passes = loop.passes()
        ctx = Context(summary, {"units": n, "seconds": window},
                      lambda: model_pass.count(cell["config"], passes), passes)
        ctx.assert_counts()
        metrics = {}
        for m in cell["per_layer"]:
            v = cells.load_module("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = summary.breakdown()
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]][0], "unit": e2e[m["name"]][1]}
                   for m in cell["end_to_end"]}
    dev_info["power_limit_w"] = _power_limit()

    loop.free()
    gc.collect()
    if _cuda(device):
        torch.cuda.empty_cache()
    numbers = loop.numbers(cell, mix["check"])
    correct, checks = check.verdict(numbers, cell["limits"])
    for c in checks.values():  # JSON has no infinity: a missing number is null
        if not math.isfinite(c["value"]):
            c["value"] = None
    out = {"correct": correct, "attempted": n, "failed": 0, "metrics": metrics,
           "device": dev_info, **result, "checks": checks}
    lines = [f"set-up: {', '.join(parts)}; peak bytes: set-up {setup_peak}, "
             f"window {peak}; units in each fifth of the window: "
             f"{' '.join(map(str, fifths))}"]
    lines += [f"check {k}: {_fmt(c['value'])} (limit {c['limit']:.6g})"
              for k, c in checks.items()]
    return out, lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.cell(args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out, lines = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), cell=cell)
    found = guard.jax_modules(sys.modules)
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print("\n".join(lines), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
