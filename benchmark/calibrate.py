#!/usr/bin/env python3
"""Readings from which a cell's limits are set; the benchmark's own runs
do not run this.

    python3 benchmark/calibrate.py --workload <name> --seeds 12 --control 3 --faults 3

For each seed, one process builds the cell's program as `run.py` does and
reads its check numbers against the f32 reference (the sound readings:
the largest over the seeds is a limit's lower end). On the first
`--control` seeds it also reads the control, the reference computed with
float8 e4m3 operands in every conv and linear layer, in the program's
place (the smallest control reading is a limit's upper end). On the
first `--faults` seeds of a training cell it also reads the program
stepping on half of each batch, the mean taken over the rest. One JSON
line a reading (training also prints, as `<kind>_look`, what no limit
holds: each step's loss gap, the bins and the worst leaves), then a
summary line. With --tf32-look a training cell also reads the
reference with cuDNN's TF32 on against itself.
"""

import argparse
import gc
import json
import sys
import time

import run  # noqa: E402  (puts the benchmark and the checkout on sys.path)
import torch  # noqa: E402

from harness import cells, check, program, weights  # noqa: E402
from reference import nets  # noqa: E402


def _rel(p, r):
    return abs(p - r) / max(abs(r), 1e-30)


def look(prog: dict, ref: dict) -> dict:
    """Readings of training that no limit holds, from the same readings
    as the compared numbers: each step's loss gap, the depth-bin ends'
    change, and the worst leaf of each gap by leaf with its name."""
    def worst(gaps):
        k = max(gaps, key=gaps.get)
        return [k, gaps[k]]

    return {"loss_steps": [_rel(p, r) for p, r in zip(prog["loss"], ref["loss"])],
            "bins_gap": max(_rel(p, r) for p, r in zip(prog["bins"], ref["bins"])),
            "grad_worst": worst(check.leaf_gaps(prog["grad"], ref["grad"])),
            "update_worst": worst(check.leaf_gaps(prog["update"], ref["update"],
                                                  check.moving(ref["grad"]))),
            "bn_worst": worst(check.leaf_gaps(prog["bn"], ref["bn"]))}


def _free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _control():
    class on:
        def __enter__(self):
            nets.PRECISION["operands"] = "fp8"

        def __exit__(self, *exc):
            nets.PRECISION["operands"] = "f32"
    return on()


class _cudnn_tf32:
    """The reference with cuDNN's TF32 on and cuBLAS's off, as PyTorch's
    defaults give a float32 program: a look at how far the training
    readings move on the reference's own round-off, with nothing of the
    program in them."""

    def __enter__(self):
        self.saved = nets.tf32_off

        class allowed(self.saved):
            def __enter__(inner):
                super().__enter__()
                torch.backends.cudnn.allow_tf32 = True

        nets.tf32_off = allowed

    def __exit__(self, *exc):
        nets.tf32_off = self.saved


def _half(loop):
    """The program's step on the first half of each batch's rows."""
    half = loop.batch // 2
    loop.pool = [{k: v[:half] for k, v in b.items()} for b in loop.pool]
    loop.draws = [{k: v[:half] for k, v in d.items()} for d in loop.draws]


def train_readings(port, cell, seed, device, control, fault, tf32_look=False):
    mix = cell["traffic"]
    sd = weights.state_dict(cell["config"], program.sub_seed(seed, 0), device)
    out = {}
    loop = run.make_loop(port, cell, sd, seed, device)
    pool, draws, drop, lr = loop.pool, loop.draws, loop.drop_seed, loop.opt.learning_rate
    loop.warm_up(mix["check"])
    prog = loop.readings
    loop.free()
    del loop
    _free(device)
    n = mix["check"]
    ref = check.reference_train(cell["config"], sd, pool[:n], draws[:n], drop, lr, device)
    out["sound"] = check.compare_train(prog, ref)
    out["sound_look"] = look(prog, ref)
    if tf32_look:
        with _cudnn_tf32():
            tf = check.reference_train(cell["config"], sd, pool[:n], draws[:n],
                                       drop, lr, device)
        out["tf32_reference"] = check.compare_train(tf, ref)
        out["tf32_reference_look"] = look(tf, ref)
    if control:
        with _control():
            ctl = check.reference_train(cell["config"], sd, pool[:n], draws[:n],
                                        drop, lr, device)
        out["control"] = check.compare_train(ctl, ref)
        out["control_look"] = look(ctl, ref)
    if fault:
        loop = run.make_loop(port, cell, sd, seed, device)
        _half(loop)
        loop.warm_up(n)
        out["half_batch"] = check.compare_train(loop.readings, ref)
        out["half_batch_look"] = look(loop.readings, ref)
        loop.free()
        del loop
    _free(device)
    return out


def serve_readings(port, cell, seed, device, control, fault, tf32_look=False):
    o = cell["config"]["options"]
    sd = weights.state_dict(cell["config"], program.sub_seed(seed, 0), device)
    loop = run.make_loop(port, cell, sd, seed, device)
    loop.warm_up(0)
    answers = [(e, loop.fn(*loop.pool[e])) for e in loop.checked]
    pool, mode = loop.pool, loop.mode
    loop.free()
    del loop
    _free(device)
    refs = {e: check.reference_disp(cell["config"], sd, pool[e], mode, device)
            for e, _ in answers}
    out = {"sound": check.compare_serve(answers, refs, o)}
    if control:
        lo, hi = 1.0 / o["max_depth"], 1.0 / o["min_depth"]
        with _control():
            ctl = [(e, 1.0 / (lo + (hi - lo) * check.reference_disp(
                cell["config"], sd, pool[e], mode, device))) for e, _ in answers]
        out["control"] = check.compare_serve(ctl, refs, o)
    _free(device)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=7_000_000_001)
    ap.add_argument("--seed-list", default=None,
                    help="comma-separated seeds to read in place of --seeds "
                         "from --first-seed (to read a few again)")
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--options", default="{}",
                    help="JSON of configuration options to change (a look only)")
    ap.add_argument("--held", default=None,
                    help="JSON of cells held out of BENCHMARK.json (its "
                         "workloads, end_to_end and per_layer), to read them too")
    ap.add_argument("--tf32-look", action="store_true",
                    help="training: also read the reference with cuDNN's TF32 "
                         "on against itself")
    args = ap.parse_args()
    device = "cuda"
    bench = cells.manifest()
    if args.held:
        with open(args.held) as f:
            held = json.load(f)
        for key in ("workloads", "end_to_end", "per_layer"):
            bench[key] += held[key]
    cell = cells.cell(args.workload, bench)
    cell["config"]["options"].update(json.loads(args.options))
    port = program.port()
    port["kernels"].build.library()
    fn = train_readings if cell["traffic"]["kind"] == "train_steps" else serve_readings
    summary = {}
    seeds = ([int(x) for x in args.seed_list.split(",")] if args.seed_list else
             [args.first_seed + 7919 * i for i in range(args.seeds)])
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        got = fn(port, cell, seed, device, i < args.control, i < args.faults,
                 args.tf32_look)
        for kind, nums in got.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "kind": kind, **nums}), flush=True)
            if kind.endswith("_look"):
                continue
            s = summary.setdefault(kind, {})
            for k, v in nums.items():
                lo, hi = s.get(k, (float("inf"), float("-inf")))
                s[k] = (min(lo, v), max(hi, v))
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s", file=sys.stderr)
    print(json.dumps({"workload": args.workload, "summary (min, max)": summary}))


if __name__ == "__main__":
    main()
