#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py              # the checks below
    python3 chip_smoke.py --profile    # and a torch.profiler breakdown of
                                       # each path's device time and of
                                       # its `ppea:` phase spans
    python3 chip_smoke.py --kernel A   # build, then kernel A's three checks
                                       # (teacher, #2, #3) alone and its
                                       # launches profiled beside cuDNN's at
                                       # every main-path shape (no "ok" line;
                                       # --sweep: times of other tiles too)
    python3 chip_smoke.py --kernel B   # build, then kernel B's check and
                                       # times alone, its launches profiled
                                       # and its host time (no "ok" line)
    python3 chip_smoke.py --kernel C   # build, then kernel C's check and its
    python3 chip_smoke.py --kernel D   # device time per launch at every path
                                       # shape beside the plain version (D:
                                       # and F.grid_sample) and the bound; no
                                       # "ok" line; --sweep: a diagnostic (C:
                                       # every (g, nv) plan and every gather
                                       # at one corner; D: a copy of the
                                       # output)
    python3 chip_smoke.py --dp_rank OUT.json ARGS...
                                       # one rank of `dp_world2` (which
                                       # starts two): the training CLI with
                                       # ARGS under torchrun's variables from
                                       # the environment, its steps, launches
                                       # and collectives written to OUT.json

Drives the port's serving paths (`ppeadepth_tpu_torch.serve.
InferenceSession`) at the shipped configuration (RepLKNet-31B + PEA
adapters, adpt_test=4, 640x192, bf16, merged deploy form, B=8, 96 depth
bins, ResNet-18 pose net), its stage-1 training step
(`ppeadepth_tpu_torch.train.step.make_train_step`, the same network in
training form, bf16 compute on f32 parameters, B=12), its stage-2 step
(`--train_cs --dc`: the dec_id-1 decoder adapters and the dc freezing, at
the CityScapes preset's 512x192), the same with the DynamicDepth cost
volume (`--dyn_cv --cv_pool`), and its CLIs (`python -m
ppeadepth_tpu_torch.train`, `evaluate_depth_layer`, `evaluate_ddad` and
`eval_depth_ori`, run in-process) on seeded random weights, after building the hand-written
kernels from `ppeadepth_tpu_torch/csrc/` and holding each against its
plain PyTorch version at the shapes the paths give it (the training
kernels at 640x192, at a --grad_accum 2 microbatch's B=6 and at stage 2's
512x192, #3 and kernel C also at the DDAD eval's 320x480, kernel C also
at the legacy eval's f32 C=64):

  * teacher `predict_depth`, 3 requests, against the CPU f32 forward;
  * student `predict_depth_multi`, 3 requests, against the CPU f32 forward;
  * `predict_pose`, 3 pairs, against the CPU f32 result;
  * one f32 training step at B=2 against the same step on the CPU;
  * 1 + 5 bf16 training steps at B=12 with their invariants checked;
  * the training CLI on a synthetic KITTI set on disk (2 epochs of 3 steps
    at B=12, bf16, with a validation and checkpoints), then a resume
    from its final checkpoint, exact;
  * `--eval --lk_backend pallas` (kernel A in place of the Pallas kernel
    #3, the stem's 3x3 conv included) and `--eval --lk_backend lax` on
    that checkpoint in f32, against each other and, on two images,
    against the port's CPU eval;
  * the per-block adapter ablation of that checkpoint (the first blocks of
    each encoder; the unablated eval equal to `--eval`'s);
  * `evaluate_ddad` on a synthetic DDAD set (1936x1216, evaluated at the
    forced 320x480) under pallas and lax, against each other and the CPU;
  * the legacy ManyDepth eval (`eval_depth_ori`, ResNet-18 with kernel C at
    f32 C=64) from seeded legacy-format checkpoints: the student,
    --eval_teacher, --zero_cost_volume and --static_camera against the CPU,
    then --save_pred_disps, --ext_disp_to_eval and the benchmark PNGs;
  * --fast_pipeline: the native loader built from the port's
    csrc/loader.cc against the vendored libjpeg-turbo headers and the
    libjpeg that Pillow bundles (decode against PIL), the augment on the
    card against the CPU, and the training CLI of above under
    --fast_pipeline --decode_cache beside the threaded loader's rate;
  * --grad_accum 2: one f32 step at B=4 against the same step on the CPU,
    and 1 + 3 bf16 steps at B=12 (two microbatches of 6: twice stage 1's
    launches), beside stage 1's wall and peak;
  * stage 2: one f32 step at B=2 against the same step on the CPU, and
    1 + 5 bf16 steps at B=12 (frozen set bit-identical, the decoder
    adapters moved), and 1 + 1 under --grad_accum 2;
  * --dyn_cv: the dyn volume on the card against the CPU, then the stage-2
    f32 parity step and 1 + 5 bf16 steps under it (kernel C not launched,
    the dyn volume once a step), lookup frames with black patches;
  * breadth (adpt_test 2 with the transition and input adapters in both
    encoders, every adapter drawn non-zero): kernel B at the C/2 adapter's
    4.5C hidden; the teacher and the student served in merged bf16 and the
    teacher under adpt_test 1, 0, 5 and 6, against the CPU f32 forward
    under `serve_drawn_adapters`' rule; one f32 step at B=2 against the
    CPU's and 1 + 3 bf16 steps at B=12 (stage 1's launches);
  * the legacy eval's ResNet-50 teacher (`eval_depth_ori --eval_teacher
    --num_layers 50`) on the synthetic KITTI set against the CPU;
  * data parallelism at world size 1 (`dp_world1`): the training CLI under
    a process group over NCCL against the same run without one, f32, one
    epoch of 3 steps, the collectives counted; and at world size 2
    (`dp_world2`): two OS processes, ranks 0 and 1 over gloo on card 0
    (NCCL refuses two ranks on one card), each the training CLI at B=6 of
    the global 12, against the same run without a group;
  * the stage-2 CLI on a synthetic CityScapes set (`--train_cs --dc --ktf
    --learning_rate 1e-5` from the KITTI run's final checkpoint: from step
    0, 2 epochs of 2 steps, a validation on the cityscapes_eval layout),
    then `--eval --eval_split cityscapes` under pallas and lax as above,
    and serving its checkpoint (one teacher and one student request
    against the CPU f32 forward, and one --dyn_cv student request).

Each path runs with the kernels' launch counts set to 0 just before it and
read just after (and each training step of the CLI by what it adds). Any failed
phase raises, so the exit code is non-zero; without a CUDA device it stops
before doing anything.

Output, in order: versions and the card's name and power limit; the kernel
build; per-shape kernel errors and times; the serving checks and times; the
training checks and times; the CLI's checks and times; one JSON line with
the kernels' summary; and as the last line `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

from ppeadepth_tpu_torch.evaluate_ddad import eval_config as ddad_eval_config
from ppeadepth_tpu_torch.options import Config

SEED = 0
BATCH = 8
REQUESTS = 3
A_REL_TOL = 1e-2        # kernel A: max|d| <= 1e-2 * max|ref| (bf16 output)
B_MAX_REL_TOL = 2.5e-2  # kernel B: tests/test_ffn_mxu.py:63-67 bounds
B_MEAN_REL_TOL = 3e-3
C_REL_TOL = 5e-5        # kernel C: the JAX mxu_f32 check's bound ...
C_BEYOND = 1e-5         # ... with at most this share of entries beyond it,
C_NEAR_PX = 1e-4        # each within this many px of an edge-mask boundary
DISP_MEAN_TOL = 5e-3    # bf16 card forward vs CPU f32 forward, |d disp|
DISP_MAX_TOL = 5e-2
# weights with drawn stage-2 decoder adapters: the bf16 forward itself sits
# at |d disp| mean ~5e-3 from the f32 one, the JAX package's as the port's
# (tests/bf16_witness.py, PERF.md section 6), so there the card's mean is
# held to this multiple of the port's bf16 plain versions' on the CPU
BF16_PLAIN_MARGIN = 1.25
POSE_TOL = 1e-4         # f32 card pose vs CPU f32 pose, max |d|
DEPTH_BINS = (0.1, 10.0)  # the JAX session's default min/max depth bin
D_FWD_TOL = 1e-5        # kernel D forward: max|d| (images in [0, 1])
D_BWD_REL_TOL = 1e-5    # kernel D coordinate gradient: max|d| <= tol x max|ref|
A_F32_REL_TOL = 1e-4    # kernel A in f32 (forward, dx): max|d| <= tol x max|ref|
TRAIN_BATCH = 12        # bench.py's train-step batch
TRAIN_STEPS = 5         # timed, after one warm-up step
MICRO_BATCH = TRAIN_BATCH // 2  # a --grad_accum 2 microbatch
ACCUM_STEPS = 3         # timed --grad_accum 2 steps, after one warm-up step
ACCUM_PARITY_BATCH = 4  # the f32 --grad_accum 2 step against the CPU's
PARITY_BATCH = 2        # the f32 card step against the f32 CPU step
PARITY_METRIC_TOL = 1e-3  # |d| of the loss and each metric (values ~0.1-1)
PARITY_GRAD_L2 = 1e-2   # relative L2 of the concatenated trainable gradient
PARITY_BIN_REL = 1e-4   # depth bins after the step, relative
LK3_F32_REL_TOL = 1e-5  # kernel #3 in f32: max|d| <= tol x max|ref|
EVAL_BATCH = 12         # --batch_size of the CLI runs
N_TRAIN = 36            # training items of the synthetic set: 3 steps an epoch
N_TEST = 17             # its test items: an eval batch and a partial one of 5
TRAIN_EPOCHS = 2
VALIDATE_EVERY = 4      # --validate_every: one validation and checkpoint
LOG_EVERY = 2           # metrics.jsonl records, every 2 steps in this run
EVAL_LAX_REL_TOL = 1e-4  # f32 eval, pallas vs lax: max|d disp| <= tol x max|ref|
EVAL_METRIC_REL_TOL = 1e-3  # ... and each metric, relative
EVAL_CPU_REL_TOL = 1e-4  # f32 eval, card vs CPU: max|d disp| <= tol x max|ref|

# H100 SXM data-sheet peaks (dense, 700 W): the bound of each kernel is
# max(bytes / memory rate, operations / peak rate of their type)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12      # CUDA cores, float32
BF16_FLOP_PER_S = 989e12    # tensor cores, bf16

# The shipped config (ckpt/models/opt.json: --adapter --rep_size b,
# adpt_test 4) at KITTI 640x192, under the port's `options.Config`, and the
# training step's: bf16 compute (bench.py's train step: no use_checkpoint,
# batch 12), Config's defaults otherwise
SHIPPED_B = Config(adapter=True, rep_size="b", height=192, width=640)
TRAIN_B = SHIPPED_B.replace(compute_dtype="bfloat16")
# Stage 2 (--train_cs --dc, the reference README's second mode): the same
# network with the dec_id-1 decoder adapters and the dc freezing, a --ktf
# warm start at learning rate 1e-5, at the CityScapes preset's 192x512
STAGE2_B = TRAIN_B.replace(train_cs=True, dc=True, dec_id=1, ktf=True,
                           learning_rate=1e-5).with_mode_presets()
# --dyn_cv: stage 2 with the DynamicDepth cost volume in place of kernel C,
# its pool in-fill on (DynamicDepth's 3-D max-pool of the unoccluded
# neighbourhood, radius 1, threshold 0.7)
DYN_B = STAGE2_B.replace(dyn_cv=True, cv_pool=True)
ACCUM_B = TRAIN_B.replace(grad_accum=2)
# Breadth: every adapter the JAX package offers, on the shipped network:
# the block and ConvFFN adapters of adpt_test 2 (Linear-GELU-Linear, the
# ConvFFN's C/2 wide, so kernel B's packed hidden is 4.5C), the transition
# adapters (drawn, not zero) and the stem's input adapter, in both encoders;
# the other variants (1 Linear, 0 Conv-Conv, 5 ConvFFN only, 6 blocks only)
# served once each
BREADTH = dict(trans=True, input=True, mono_trans=True, mono_input=True)
BREADTH_B = SHIPPED_B.replace(adpt_test=2, **BREADTH)
TRAIN_BREADTH = TRAIN_B.replace(adpt_test=2, **BREADTH)
BREADTH_VARIANTS = (1, 0, 5, 6)
BREADTH_STEPS = 3       # timed breadth training steps, after one warm-up step
DP_EPOCHS = 1           # dp_world1: one epoch of the CLI, 3 steps of B=12
DP_DRIFT_REL = 5e-3     # ... each step's loss against the plain run's
DP_WORLD = 2            # dp_world2's ranks, both on card 0 over gloo
DP_RANK_TIMEOUT = 600   # seconds a rank may take, start-up included
DYN_REL_TOL = C_REL_TOL  # the dyn volume on the card vs the CPU, off the
                         # edge-mask boundaries: max|d| <= tol x max|ref|
CHUNK_ITEMS = 4         # the dyn volume timed also at this many items a chunk
# DDAD evaluation: the shipped network at the reference's forced 320x480
DDAD_B = ddad_eval_config(SHIPPED_B)
N_DDAD = 14             # DDAD samples: an eval batch and a partial one of 2
DDAD_RAW = (1216, 1936)  # the native camera's height, width
ABLATED = 2             # blocks of each encoder the ablation phase gates off
N_CS_TRAIN = 24         # stage-2 CLI: training triplets, 2 steps an epoch
N_CS_TEST = 14          # its test frames: an eval batch and a partial one of 2
CS_EPOCHS = 2
CS_VALIDATE_EVERY = 4   # one validation and checkpoint, at the last step
CS_CITY = "aachen"


def _time_turns(fns, iters):
    """Warm CUDA-event times (ms per call) of each of `fns`, run in turns
    forward then backward (a, b, c, c, b, a); each the mean of its two."""
    import torch

    def run(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    first = [run(fn) for fn in fns]
    second = [run(fn) for fn in reversed(fns)][::-1]
    return [(a + b) / 2 for a, b in zip(first, second)]


def _time_pair(plain, kernel, iters):
    """(plain_ms, kernel_ms) per call, timed in turns by `_time_turns`."""
    return tuple(_time_turns([plain, kernel], iters))


def _bound_ms(nbytes, flop, peak):
    """(least time in ms, what bounds it) for moving `nbytes` once and
    doing `flop` operations at `peak` operations/s."""
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, flop / peak
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


class _Bound:
    """Sum of per-call bounds over a forward, and what bounds most of it."""

    def __init__(self):
        self.ms, self.by_ms = 0.0, {"bytes": 0.0, "operations": 0.0}

    def add(self, ms, by, calls):
        self.ms += ms * calls
        self.by_ms[by] += ms * calls

    @property
    def by(self):
        return max(self.by_ms, key=self.by_ms.get)


def _stage_shapes(opt=SHIPPED_B):
    """(C, H, W, k, blocks) of the four encoder stages at opt's size
    (640x192 for the shipped configuration, 512x192 for stage 2)."""
    from ppeadepth_tpu_torch.models.replknet import REPLK_CONFIGS

    cfg = REPLK_CONFIGS[opt.rep_size]
    return [(cfg["channels"][i], opt.height // 4 >> i, opt.width // 4 >> i,
             cfg["large_kernel_sizes"][i], cfg["layers"][i])
            for i in range(4)]


def _dw_macs(B, H, W, C, k):
    """Multiply-adds a SAME depthwise conv needs once taps that fall on
    padding are dropped (what the kernel's tap clipping aims at)."""
    def taps(n):
        h = k // 2
        return sum(min(n - 1, o + h) - max(0, o - h) + 1 for o in range(n))

    return B * C * taps(H) * taps(W)


def _lk_tensor_bound_ms(B, H, W, C, k):
    """Kernel A's bound as the benchmark's roofline counts it
    (`benchmark/roofline/lk_dwconv.py`): the clipped taps' operations at
    the bf16 tensor rate, or the bf16 input, output and weights once at
    HBM rate, the larger; with what bounds it."""
    return _bound_ms(2 * (2 * B * H * W * C + C * k * k),
                     2 * _dw_macs(B, H, W, C, k), BF16_FLOP_PER_S)


def _lk_bound_ms(B, H, W, C, k, dtype):
    """Kernel A's bound for a launch at the rate of the instance
    `lk_plan` takes: the bf16 tensor rate for the banded one, the f32 FMA
    rate for the CUDA-core ones; (ms, what bounds it, the rate's name)."""
    import torch

    from ppeadepth_tpu_torch.kernels.lk_conv import BandPlan, lk_plan

    if isinstance(lk_plan(B, H, W, C, k, dtype), BandPlan):
        return (*_lk_tensor_bound_ms(B, H, W, C, k), "bf16 tensor")
    esize = 2 if dtype == torch.bfloat16 else 4
    return (*_bound_ms(esize * (2 * B * H * W * C + C * k * k),
                       2 * _dw_macs(B, H, W, C, k), F32_FLOP_PER_S), "f32 FMA")


def check_lk_dwconv(dev, rng):
    """Kernel A against its plain version (one cuDNN call, which is also
    the library yardstick) at the four stage shapes. Times and bounds are
    per teacher forward (the sum over its 24 calls). At k >= 13 (the
    banded instance) also the CUDA-core instance's time and the bound at
    the bf16 tensor rate beside the FMA one."""
    import torch

    from ppeadepth_tpu_torch.kernels.lk_conv import (
        BandPlan, _launch, depthwise_plain, lk_depthwise, lk_fma_plan, lk_plan)

    worst, ms, plain_ms, bound = 0.0, 0.0, 0.0, _Bound()
    for C, H, W, k, blocks in _stage_shapes():
        x = torch.from_numpy(rng.randn(BATCH, H, W, C).astype("float32")).to(
            dev).bfloat16().permute(0, 3, 1, 2)
        w = torch.from_numpy((rng.randn(C, 1, k, k) / k).astype("float32")).to(
            dev).bfloat16()
        b = torch.from_numpy((rng.randn(C) * 0.1).astype("float32")).to(
            dev).bfloat16()
        y = lk_depthwise(x, w, b)
        torch.cuda.synchronize()
        ref = depthwise_plain(x.float(), w.float(), b.float())
        err = (y.float() - ref).abs().max().item()
        peak = ref.abs().max().item()
        print(f"kernel A  [{BATCH},{H},{W},{C}] k={k}: max|d|={err:.3e} "
              f"max|ref|={peak:.3e} (tol {A_REL_TOL:g} x max|ref|)")
        if not err <= A_REL_TOL * peak:
            raise AssertionError(f"kernel A disagrees at C={C} k={k}: {err}")
        worst = max(worst, err)
        p, kk = _time_pair(lambda: depthwise_plain(x, w, b),
                           lambda: lk_depthwise(x, w, b), 20)
        macs = _dw_macs(BATCH, H, W, C, k)
        bnd, by = _bound_ms(2 * (2 * BATCH * H * W * C + C * k * k + C),
                            2 * macs, F32_FLOP_PER_S)
        print(f"kernel A  [{BATCH},{H},{W},{C}] k={k}: {kk:.4f} ms/call "
              f"({macs / kk / 1e9:.2f} T multiply-adds/s of {macs / 1e9:.2f} G), "
              f"plain (cuDNN bf16) {p:.4f} ms/call, bound {bnd:.4f} ms "
              f"({by}), x{blocks} per forward")
        if isinstance(lk_plan(BATCH, H, W, C, k, torch.bfloat16), BandPlan):
            fma = lk_fma_plan(BATCH, H, W, C, k, torch.bfloat16)
            _, f = _time_pair(lambda: depthwise_plain(x, w, b),
                              lambda: _launch(x, w, b, "lk_dwconv", plan=fma), 20)
            tb, tby = _lk_tensor_bound_ms(BATCH, H, W, C, k)
            print(f"kernel A  [{BATCH},{H},{W},{C}] k={k}: banded {kk:.4f} ms/call, "
                  f"CUDA-core instance {f:.4f} ms/call (x{f / kk:.2f}), cuDNN "
                  f"{p:.4f} ms/call; bounds: FMA {bnd:.4f} ms, tensor rate "
                  f"{tb:.4f} ms ({tby}; {100 * tb / kk:.2f} % of its roofline)")
        ms += kk * blocks
        plain_ms += p * blocks
        bound.add(bnd, by, blocks)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound.ms,
                bound_by=bound.by, library_ms=plain_ms)


# kernel B's widest ConvFFNs beyond the shipped rep_size b: stage 3 of
# rep_size l (C=1536) and xl (C=2048) at 640x192, B=8; checked, not summed
# into the per-forward times
B_WIDE = ((1536, 6, 20), (2048, 6, 20))


def check_ffn_fused(dev, rng, adapter_div=4):
    """Kernel B against its plain version at the four stage shapes, with
    the adapter (the main path) and without it, and at the L/XL widths of
    `B_WIDE`; with adapter_div=2 (adpt_test 2's C/2 adapter, a packed
    hidden of 4.5C) at the stage shapes with the adapter only. The kernel runs on the packed operands (`pack_ffn`, as
    `ConvFFN.fold` stores them) and is held against the plain version on
    the unpacked ones. Times and bounds are per teacher forward (the sum
    over its 24 calls, with the adapter); beside them the two packed
    products alone as bare bf16 `torch.mm` calls, the cuBLAS tensor-core
    yardstick (`cublas_products_ms`)."""
    import torch

    from ppeadepth_tpu_torch.kernels.ffn_fused import (
        FoldedFFN, ffn_fused, ffn_fused_plain, ffn_plan, pack_ffn)

    def t(shape, scale, dtype=torch.bfloat16):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype("float32")).to(dev).to(dtype)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst, ms, plain_ms, mm_ms, bound = 0.0, 0.0, 0.0, 0.0, _Bound()
    cases = [(C, H, W, blocks, True) for C, H, W, _, blocks in _stage_shapes()]
    if adapter_div == 4:
        cases += [c[:4] + (False,) for c in cases]
        cases += [(C, H, W, 0, True) for C, H, W in B_WIDE]
    for C, H, W, blocks, adapter in cases:
        M, H4, CA = BATCH * H * W, 4 * C, C // adapter_div
        f32 = torch.float32
        p = FoldedFFN(t((C, H4), C ** -0.5), t((H4,), 0.1, f32),
                      t((H4, C), H4 ** -0.5), t((C,), 0.1, f32),
                      *((t((C, CA), C ** -0.5), t((CA,), 0.1, f32),
                         t((CA, C), CA ** -0.5), t((C,), 0.1, f32))
                        if adapter else ()))
        pk = pack_ffn(p)
        x = t((BATCH, H, W, C), 1.0).permute(0, 3, 1, 2)
        y = ffn_fused(x, pk)
        torch.cuda.synchronize()
        pf = FoldedFFN(*(v.float() if v is not None else None for v in p))
        x2d = x.permute(0, 2, 3, 1).reshape(M, C)
        ref = ffn_fused_plain(x2d.float(), pf)
        diff = (y.permute(0, 2, 3, 1).reshape(M, C).float() - ref).abs()
        scale = ref.abs().max().item()
        mx, mean = diff.max().item(), diff.mean().item()
        Hp = pk.w_up.shape[0]
        tiles = ffn_plan(M, C, Hp, sms)
        tag = f"kernel B  [{M},{C}] adapter={CA if adapter else 0}"
        print(f"{tag}: max|d|={mx:.3e} max rel {mx / scale:.3e} "
              f"mean rel {mean / scale:.3e} (tol {B_MAX_REL_TOL:g} / "
              f"{B_MEAN_REL_TOL:g}); Hp={Hp}, tiles up/down {tiles}")
        if not (mx / scale < B_MAX_REL_TOL and mean / scale < B_MEAN_REL_TOL):
            raise AssertionError(f"kernel B disagrees at C={C}: {mx}, {mean}")
        worst = max(worst, mx)
        h = torch.empty((M, Hp), dtype=torch.bfloat16, device=dev)
        wu, wd = pk.w_up.t(), pk.w_down.t()

        def products():
            torch.mm(x2d, wu, out=h)
            return torch.mm(h, wd)

        pl, kk, mm = _time_turns([lambda: ffn_fused_plain(x2d, p),
                                  lambda: ffn_fused(x, pk), products], 20)
        ca = CA if adapter else 0
        flop = 2 * M * C * (2 * H4 + 2 * ca)
        nbytes = (2 * 2 * M * C + 2 * 2 * C * (H4 + ca)
                  + 4 * (H4 + C + (ca + C if adapter else 0)))
        bnd, by = _bound_ms(nbytes, flop, BF16_FLOP_PER_S)
        print(f"{tag}: {kk:.4f} ms/call ({flop / kk / 1e9:.1f} TFLOP/s), "
              f"plain (cuBLAS bf16) {pl:.4f} ms/call, packed products alone "
              f"(2 bf16 torch.mm) {mm:.4f} ms/call, bound {bnd:.4f} ms "
              f"({by}), x{blocks} per forward")
        if adapter:
            ms += kk * blocks
            plain_ms += pl * blocks
            mm_ms += mm * blocks
            bound.add(bnd, by, blocks)
    print(f"kernel B per teacher forward (24 calls): {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, packed products in cuBLAS {mm_ms:.4f} ms, "
          f"bound {bound.ms:.4f} ms ({bound.by})")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound.ms,
                bound_by=bound.by, library_ms=None, cublas_products_ms=mm_ms)


def profile_ffn_launches(dev, rng):
    """`--kernel B` only: per stage shape (with the adapter), the device
    time of each of kernel B's two launches (up, down) beside cuBLAS's
    two launches of the packed products (torch.profiler), and the host
    time of one `ffn_fused` call, enqueued behind a busy device."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ppeadepth_tpu_torch.kernels.ffn_fused import (
        FoldedFFN, ffn_fused, pack_ffn)

    def t(shape, scale, dtype=torch.bfloat16):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype("float32")).to(dev).to(dtype)

    for C, H, W, _, _ in _stage_shapes():
        M, H4, CA = BATCH * H * W, 4 * C, C // 4
        f32 = torch.float32
        pk = pack_ffn(FoldedFFN(
            t((C, H4), C ** -0.5), t((H4,), 0.1, f32), t((H4, C), H4 ** -0.5),
            t((C,), 0.1, f32), t((C, CA), C ** -0.5), t((CA,), 0.1, f32),
            t((CA, C), CA ** -0.5), t((C,), 0.1, f32)))
        x = t((BATCH, H, W, C), 1.0).permute(0, 3, 1, 2)
        x2d = x.permute(0, 2, 3, 1).reshape(M, C)
        h = torch.empty((M, pk.w_up.shape[0]), dtype=torch.bfloat16, device=dev)
        for _ in range(3):
            ffn_fused(x, pk)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                ffn_fused(x, pk)
                torch.mm(x2d, pk.w_up.t(), out=h)
                torch.mm(h, pk.w_down.t())
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_time_total > 0 and "Memset" not in e.key:
                print(f"kernel B launches [{M},{C}]: {e.device_time_total / e.count:.2f} "
                      f"us x{e.count}: {e.key[:100]}")
        torch.cuda._sleep(1_000_000)  # keep the device busy while enqueuing
        t0 = time.perf_counter()
        for _ in range(50):
            ffn_fused(x, pk)
        host_us = (time.perf_counter() - t0) / 50 * 1e6
        torch.cuda.synchronize()
        print(f"kernel B host [{M},{C}]: {host_us:.1f} us per ffn_fused call "
              f"(wrapper, 4 tensor maps, 2 launches)")


def _lk_shapes():
    """(B, H, W, C, k) of every kernel A call of the main paths: the
    teacher's stages at B=8, the training step's convs at B=12 and the
    eval's (the stem's k=3 included) at B=12."""
    shapes = {(BATCH, H, W, C, k) for C, H, W, k, _ in _stage_shapes()}
    shapes |= {(TRAIN_BATCH, H, W, C, k)
               for C, H, W, k, _, _ in _train_lk_calls(TRAIN_B)}
    shapes |= {(EVAL_BATCH, H, W, C, k)
               for C, H, W, k, _ in _eval_lk_calls(SHIPPED_B)}
    return sorted(shapes, key=lambda s: (s[4], -s[1]))


def profile_lk_launches(dev, rng):
    """`--kernel A` only: per main-path shape and type, the device time
    of one kernel A launch (forward, and dx on the flipped kernel) beside
    cuDNN's depthwise `F.conv2d` (torch.profiler, us per launch), with the
    launch's plan and its multiply-add rate, and the host time of one
    `lk_depthwise` call and of one `F.conv2d` call, enqueued behind a busy
    device."""
    import torch

    from ppeadepth_tpu_torch.kernels.lk_conv import (
        _input_grad, depthwise_plain, lk_depthwise, lk_plan)

    for B, H, W, C, k in _lk_shapes():
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.from_numpy(rng.randn(B, H, W, C).astype("float32")).to(
                dev).to(dtype).permute(0, 3, 1, 2)
            w = torch.from_numpy((rng.randn(C, 1, k, k) / k).astype(
                "float32")).to(dev).to(dtype)
            ours = _device_us(lambda: (lk_depthwise(x, w), _input_grad(x, w))) / 2
            lib = _device_us(lambda: depthwise_plain(x, w))
            ev_ours, ev_lib = _time_turns([lambda: lk_depthwise(x, w),
                                           lambda: depthwise_plain(x, w)], 50)
            host = []
            for fn in (lambda: lk_depthwise(x, w), lambda: depthwise_plain(x, w)):
                torch.cuda._sleep(2_000_000)  # enqueue behind a busy device
                t0 = time.perf_counter()
                for _ in range(50):
                    fn()
                host.append((time.perf_counter() - t0) / 50 * 1e6)
                torch.cuda.synchronize()
            macs = _dw_macs(B, H, W, C, k)
            bnd, by, rate = _lk_bound_ms(B, H, W, C, k, dtype)
            print(f"kernel A launch [{B},{H},{W},{C}] k={k} {str(dtype)[6:]}: "
                  f"{ours:.2f} us (forward and dx), cuDNN {lib:.2f} us, "
                  f"CUDA events {ev_ours * 1e3:.2f} / {ev_lib * 1e3:.2f} us, "
                  f"x{lib / ours:.2f}; bound {bnd * 1e3:.2f} us ({by}, {rate}); host "
                  f"{host[0]:.1f} us a call, cuDNN's {host[1]:.1f} us; "
                  f"{macs / ours / 1e6:.2f} T multiply-adds/s "
                  f"({100 * bnd * 1e3 / ours:.1f} % of the bound); plan "
                  f"{lk_plan(B, H, W, C, k, dtype)}")


def profile_lk_banded(dev, rng, sweep=False):
    """`--kernel A` only: per encoder stage at the serving batch (B=32) at
    640x192 and 512x192, the device time (`_device_us`) of one launch of
    the banded instance, of the CUDA-core instance and of cuDNN's depthwise
    `F.conv2d`, beside the FMA bound and the benchmark's tensor-rate bound;
    the banded forward against the plain version; with `sweep`, the device
    time of the best-ranked plans of `band_plans`."""
    import torch

    from ppeadepth_tpu_torch.kernels.lk_conv import (
        _launch, band_plans, depthwise_plain, lk_fma_plan, lk_plan)

    B = 32
    for opt in (SHIPPED_B, Config(adapter=True, rep_size="b", height=192, width=512)):
        for C, H, W, k, blocks in _stage_shapes(opt):
            x = torch.from_numpy(rng.randn(B, H, W, C).astype("float32")).to(
                dev).bfloat16().permute(0, 3, 1, 2)
            w = torch.from_numpy((rng.randn(C, 1, k, k) / k).astype("float32")).to(
                dev).bfloat16()
            b = torch.from_numpy((rng.randn(C) * 0.1).astype("float32")).to(
                dev).bfloat16()
            plan = lk_plan(B, H, W, C, k, torch.bfloat16)
            fma = lk_fma_plan(B, H, W, C, k, torch.bfloat16)
            y = _launch(x, w, b, "lk_dwconv", plan=plan)
            ref = depthwise_plain(x.float(), w.float(), b.float())
            err = (y.float() - ref).abs().max().item() / ref.abs().max().item()
            band = _device_us(lambda: _launch(x, w, b, "lk_dwconv", plan=plan))
            core = _device_us(lambda: _launch(x, w, b, "lk_dwconv", plan=fma))
            lib = _device_us(lambda: depthwise_plain(x, w, b))
            macs = _dw_macs(B, H, W, C, k)
            fb, _ = _bound_ms(2 * (2 * B * H * W * C + C * k * k), 2 * macs,
                              F32_FLOP_PER_S)
            tb, tby = _lk_tensor_bound_ms(B, H, W, C, k)
            print(f"kernel A stage [{B},{H},{W},{C}] k={k} x{blocks}: banded "
                  f"{band:.2f} us ({2 * macs / band / 1e6:.1f} TFLOP/s, "
                  f"{100 * tb * 1e3 / band:.2f} % of the roofline), CUDA-core "
                  f"{core:.2f} us (x{core / band:.2f}), cuDNN {lib:.2f} us; "
                  f"bounds FMA {fb * 1e3:.2f} us, tensor rate {tb * 1e3:.2f} us "
                  f"({tby}); max|d|/max|ref| {err:.2e}; plan ni={plan.ni} "
                  f"th={plan.th} nt={plan.nt} segs={plan.segs} warps={plan.warps} "
                  f"smem={plan.smem} blocks/SM={plan.blocks_per_sm}")
            if sweep:
                plans = list(band_plans(B, H, W, C, k))
                picked = [p for i, p in enumerate(plans)
                          if all((p.ni, p.nt, p.warps, p.th) != (q.ni, q.nt, q.warps, q.th)
                                 for q in plans[:i])][:20]
                us = [_device_us(lambda p=p: _launch(x, w, b, "lk_dwconv", plan=p))
                      for p in picked]
                print(f"kernel A banded sweep [{B},{H},{W},{C}] k={k}: " + " ".join(
                    f"ni{p.ni}/th{p.th}/nt{p.nt}/w{p.warps}/bps{p.blocks_per_sm}"
                    f":{t:.2f}" for p, t in zip(picked, us)))


def _clocks(tag):
    """The card's SM clock, power draw and temperature now (nvidia-smi)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"clocks {tag}: {smi.stdout.strip()}")


def _device_us(fn, iters=20, reps=5):
    """Device time per call of `fn` in us: `iters` calls captured in one
    CUDA graph, replayed `reps` times between two CUDA events, after three
    warm calls. The graph takes the host out of the time (a small conv's
    launch costs more host time than device time) and, unlike a
    torch.profiler trace, drops no kernel."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    graph.reset()  # free the graph's memory pool now, not at collection
    return start.elapsed_time(end) * 1e3 / (iters * reps)


def sweep_lk_plans(dev, rng):
    """`--kernel A --sweep` only: per main-path shape and type, the
    forward's device time (`_device_us`) under `lk_plan`'s pick, then
    every plan `lk_plans` ranks at k <= 7 and the best-ranked for each
    strip and row count above, so
    the plan's model can be held against the card; at k <= 7 also
    cuDNN's time and that of a plain copy of x (the same bytes in and out:
    the practical floor of a bytes-bound conv)."""
    import torch

    from ppeadepth_tpu_torch.kernels.lk_conv import (
        _launch, depthwise_plain, lk_plan, lk_plans)

    for B, H, W, C, k in _lk_shapes():
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.from_numpy(rng.randn(B, H, W, C).astype("float32")).to(
                dev).to(dtype).permute(0, 3, 1, 2)
            w = torch.from_numpy((rng.randn(C, 1, k, k) / k).astype(
                "float32")).to(dev).to(dtype)
            plans = [lk_plan(B, H, W, C, k, dtype), *lk_plans(B, H, W, C, k, dtype)]
            if k > 7:  # the best-ranked for each strip count and row count
                plans = [p for i, p in enumerate(plans) if all(
                    p.tws != q.tws or p.th != q.th for q in plans[:i])]
                plans = [p for i, p in enumerate(plans)
                         if p.tws not in {q.tws for q in plans[:i]}
                         or p.th not in {q.th for q in plans[:i]}][:8]
            us = [_device_us(lambda p=p: _launch(x, w, None, "lk_dwconv", plan=p))
                  for p in plans]
            lib = _device_us(lambda: depthwise_plain(x, w)) if k <= 7 else None
            copy = _device_us(x.clone) if k <= 7 else None
            best = min(range(len(plans)), key=us.__getitem__)
            print(f"kernel A sweep [{B},{H},{W},{C}] k={k} {str(dtype)[6:]}: "
                  f"plan th={plans[0].th} tws={plans[0].tws} nbuf={plans[0].nbuf} "
                  f"{us[0]:.2f} us, best th={plans[best].th} tws={plans[best].tws} "
                  f"nbuf={plans[best].nbuf} {us[best]:.2f} us"
                  + (f", cuDNN {lib:.2f} us, copy of x (x.clone) {copy:.2f} us"
                     if lib is not None else "") + "; all: "
                  + " ".join(f"{p.th}/{p.tws}/{p.nbuf}:{t:.2f}" for p, t in zip(plans, us)))


def _kitti_K(height, width, batch):
    """KITTI intrinsics scaled to height x width, and their pinv, as
    [batch, 4, 4] float32 numpy (the JAX trainer's `synthetic_batch`)."""
    import numpy as np

    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1] = 0.58 * width, 1.92 * height
    K[0, 2], K[1, 2] = 0.5 * width, 0.5 * height
    K = np.repeat(K[None], batch, 0)
    return K, np.linalg.pinv(K).astype(np.float32)


def _pose_4x4(rng, batch):
    """[batch, 4, 4] non-degenerate poses: small rotation and an x+y+z
    translation, so no sample sits on the 2-px edge-mask boundary."""
    import numpy as np

    T = np.repeat(np.eye(4, dtype=np.float32)[None], batch, 0)
    for b in range(batch):
        th = rng.randn(3) * 0.01
        c, s = np.cos(th), np.sin(th)
        T[b, :3, :3] = (np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
                        @ np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
                        @ np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]]))
        T[b, :3, 3] = rng.randn(3) * [0.03, 0.01, 0.05] + [0.05, 0.01, 0.1]
    return T


def _sweep_geometry(dev, rng, B, C, H, W, D):
    """Kernel C's geometry at B items: (A, t, bins) of non-degenerate poses
    under 1/4-scale KITTI intrinsics and D log bins 0.1-10, the mask of
    samples within C_NEAR_PX of an edge-mask boundary [B, D, H, W], and the
    count of observed samples (inside both masks)."""
    import torch

    from ppeadepth_tpu_torch.ops.cost_volume import compute_depth_bins

    K, invK = (torch.from_numpy(a).to(dev) for a in _kitti_K(H, W, B))
    T = torch.from_numpy(_pose_4x4(rng, B)).to(dev)
    bins = compute_depth_bins(*DEPTH_BINS, D, device=dev)
    return _edge_geometry(K, invK, T, bins, H, W)


def _edge_geometry(K, invK, T, bins, H, W):
    """(A, t, bins, near, samples) of `_sweep_geometry` for the poses T
    [B, 4, 4] under K, invK [B, 4, 4]."""
    import torch

    from ppeadepth_tpu_torch.ops.cost_volume import project

    B, D = T.shape[0], bins.shape[0]
    dev = T.device
    P = (K @ T)[:, :3]
    A = (P[:, :, :3] @ invK[:, :3, :3]).contiguous()
    t = P[:, :, 3].contiguous()
    x, y = project(A, t, bins, H, W)
    edge = (x >= 2) & (x <= W - 2) & (y >= 2) & (y <= H - 2)
    near = torch.minimum(torch.minimum((x - 2).abs(), (x - (W - 2)).abs()),
                         torch.minimum((y - 2).abs(), (y - (H - 2)).abs())
                         ) < C_NEAR_PX
    gy, gx = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    border = ((gy >= 2) & (gy < H - 2) & (gx >= 2) & (gx < W - 2)).reshape(-1)
    samples = (edge & border).sum().item()
    return A, t, bins, near.reshape(B, D, H, W), samples


def _sweep_feats(dev, rng, B, C, H, W, dtype):
    """One [B, C, H, W] channels_last feature map of `dtype`, N(0, 1)."""
    import torch

    return torch.from_numpy(rng.randn(B, H, W, C).astype("float32")).to(
        dev).to(dtype).permute(0, 3, 1, 2)


def _hold_sweep(tag, got, ref, near, samples):
    """Kernel C's limits: at most C_BEYOND of the entries beyond C_REL_TOL x
    max|ref|, each within C_NEAR_PX of an edge-mask boundary; returns
    max|d|."""
    diff = (got - ref).abs()
    peak = ref.abs().max().item()
    beyond = diff > C_REL_TOL * peak
    n_beyond = beyond.sum().item()
    n_off = (beyond & ~near).sum().item()
    print(f"{tag}: max|d|={diff.max().item():.3e} max|ref|={peak:.3e}; "
          f"{n_beyond} of {diff.numel()} entries beyond {C_REL_TOL:g} x "
          f"max|ref| ({n_off} of them off a mask boundary); observed "
          f"samples {samples} of {diff.numel()}; tol: at most "
          f"{C_BEYOND:g} of the entries beyond, each within {C_NEAR_PX:g} px "
          f"of a mask boundary")
    if n_off or n_beyond > C_BEYOND * diff.numel():
        raise AssertionError(f"{tag} disagrees: {n_beyond} beyond, {n_off} "
                             f"off a boundary")
    if not (ref > 0).float().mean().item() > 0.1:
        raise AssertionError(f"{tag}: too few samples observed")
    return diff.max().item()


def _sweep_bound(B, C, H, W, D, samples, itemsize):
    """(bound ms, what bounds it, flop, bytes) of one kernel C call: per
    observed sample 12 f32 operations a channel (bilinear 9, sub, abs,
    sum), per (item, bin, pixel) ~12 for the projection; the features read
    once, the output written once."""
    flop = 12 * C * samples + 12 * B * D * H * W
    nbytes = 2 * B * H * W * C * itemsize + 4 * B * D * H * W
    return (*_bound_ms(nbytes, flop, F32_FLOP_PER_S), flop, nbytes)


def check_plane_sweep(dev, rng, batch=BATCH, opt=SHIPPED_B, dtypes=None,
                      channels=None):
    """Kernel C against its plain version at a main-path shape (the
    student's: B=8, 48x160; the stage-2 step's: B=12, 48x128; the DDAD
    eval's: B=12, 80x120; a --grad_accum 2 microbatch's: B=6, 48x160;
    C=128, or `channels`: the legacy eval's C=64; 96 log bins 0.1-10,
    1/4-scale KITTI intrinsics, a non-degenerate pose), with f32 and with
    bf16 features (or `dtypes`), each timed by CUDA events as the other
    kernels of the full run; the times returned are the last dtype's
    (bf16, the serving and training paths' dtype, unless `dtypes` says
    otherwise)."""
    import torch

    from ppeadepth_tpu_torch.kernels.cost_volume import plane_sweep, plane_sweep_plain

    C, H, W, _, _ = _stage_shapes(opt)[0]
    C = channels or C
    D = opt.num_depth_bins
    A, t, bins, near, samples = _sweep_geometry(dev, rng, batch, C, H, W, D)

    worst, out = 0.0, {}
    for dtype in dtypes or (torch.float32, torch.bfloat16):
        cur = _sweep_feats(dev, rng, batch, C, H, W, dtype)
        lk = _sweep_feats(dev, rng, batch, C, H, W, dtype)
        got = plane_sweep(cur, lk, A, t, bins)
        torch.cuda.synchronize()
        ref = plane_sweep_plain(cur, lk, A, t, bins)
        tag = f"kernel C  [{batch},{H},{W},{C}] D={D} {str(dtype)[6:]}"
        worst = max(worst, _hold_sweep(tag, got, ref, near, samples))
        pl, kk = _time_pair(lambda: plane_sweep_plain(cur, lk, A, t, bins),
                            lambda: plane_sweep(cur, lk, A, t, bins), 5)
        bnd, by, flop, nbytes = _sweep_bound(batch, C, H, W, D, samples,
                                             cur.element_size())
        print(f"{tag}: {kk:.4f} ms/call ({flop / kk / 1e9:.2f} TFLOP/s of "
              f"{flop / 1e9:.2f} GFLOP), plain (torch gather) {pl:.4f} ms/call, "
              f"bound {bnd:.4f} ms ({by}: {nbytes / 1e6:.1f} MB)")
        out = dict(ms=kk, plain_ms=pl, bound_ms=bnd, bound_by=by)
    return dict(max_abs_err=worst, library_ms=None, **out)


def _sweep_shapes():
    """(B, C, dtype) of kernel C's calls on the paths at 48x160, D=96:
    serving (B=8) and the training step (B=12) in bf16, the eval (B=12)
    in f32, and rep_size l / xl's stage-0 widths (C=192, 256) in bf16."""
    import torch

    return ((BATCH, 128, torch.bfloat16), (TRAIN_BATCH, 128, torch.bfloat16),
            (EVAL_BATCH, 128, torch.float32), (BATCH, 192, torch.bfloat16),
            (BATCH, 256, torch.bfloat16))


def time_plane_sweep(dev, rng, sweep):
    """`--kernel C`: at every shape of `_sweep_shapes`, kernel C held to its
    plain version, then its device time per launch (`_device_us`) beside
    the plain version's (CUDA events) and the bound. With `sweep`, also
    every (g, nv), and the chosen plan with every gather pointed at one
    corner (arithmetic and shuffles without the gather's cost)."""
    from ppeadepth_tpu_torch.kernels.cost_volume import (
        SweepPlan, _launch, plane_sweep, plane_sweep_plain, sweep_plan)

    H, W, D = 48, 160, SHIPPED_B.num_depth_bins
    rows = {}
    for B, C, dtype in _sweep_shapes():
        A, t, bins, near, samples = _sweep_geometry(dev, rng, B, C, H, W, D)
        cur = _sweep_feats(dev, rng, B, C, H, W, dtype)
        lk = _sweep_feats(dev, rng, B, C, H, W, dtype)
        tag = f"kernel C  [{B},{H},{W},{C}] D={D} {str(dtype)[6:]}"
        ref = plane_sweep_plain(cur, lk, A, t, bins)
        err = _hold_sweep(tag, plane_sweep(cur, lk, A, t, bins), ref, near,
                          samples)
        plan = sweep_plan(C, dtype)
        us = _device_us(lambda: plane_sweep(cur, lk, A, t, bins))
        (pl,) = _time_turns([lambda: plane_sweep_plain(cur, lk, A, t, bins)], 3)
        bnd, by, flop, _ = _sweep_bound(B, C, H, W, D, samples,
                                        cur.element_size())
        print(f"{tag} launch: {us:.2f} us ({flop / us / 1e6:.2f} TFLOP/s, "
              f"{100 * bnd * 1e3 / us:.1f} % of the bound), plain "
              f"{pl * 1e3:.2f} us, bound {bnd * 1e3:.2f} us ({by}); plan {plan}")
        rows[tag] = dict(us=us, plain_us=pl * 1e3, bound_us=bnd * 1e3,
                         bound_by=by, max_abs_err=err, plan=list(plan))
        if not sweep:
            continue
        fixed = _device_us(lambda: _launch(cur, lk, A, t, bins, plan, fixed=True))
        plans = [SweepPlan(g, nv) for g in (4, 8, 16) for nv in (1, 2, 3, 4)
                 if g * nv * 16 >= C * cur.element_size()
                 and g * (nv - 1) * 16 < C * cur.element_size()]
        times = []
        for p in plans:
            got = _launch(cur, lk, A, t, bins, p)
            _hold_sweep(f"{tag} {tuple(p)}", got, ref, near, samples)
            times.append(_device_us(lambda p=p: _launch(cur, lk, A, t, bins, p)))
        best = min(range(len(plans)), key=times.__getitem__)
        print(f"kernel C sweep {tag[10:]}: plan {tuple(plan)} {us:.2f} us, "
              f"every gather at one corner {fixed:.2f} us (gathers "
              f"{100 * (1 - fixed / us):.1f} % of the time), best "
              f"{tuple(plans[best])} {times[best]:.2f} us; all (g, nv): "
              + " ".join(f"{tuple(p)}:{x:.2f}" for p, x in zip(plans, times)))
        rows[tag].update(fixed_corner_us=fixed, best=list(plans[best]),
                         best_us=times[best])
    return rows


def _warp_inputs(dev, rng, n, height, width):
    """Kernel D's main-path inputs: n RGB images [n, H, W, 3] in [0, 1] and
    the coordinates of a smooth random depth map (1-80 m) reprojected
    through a non-degenerate pose with KITTI intrinsics, some out of
    range."""
    import torch
    import torch.nn.functional as F

    from ppeadepth_tpu_torch.core.geometry import reproject_coords

    img = torch.from_numpy(rng.rand(n, height, width, 3).astype("float32")).to(dev)
    disp = torch.from_numpy(rng.rand(n, 1, height // 16, width // 16)
                            .astype("float32")).to(dev)
    disp = F.interpolate(disp, size=(height, width), mode="bilinear",
                         align_corners=False)
    depth = 1.0 / (disp * (1 / 1.0 - 1 / 80.0) + 1 / 80.0)
    K, invK = (torch.from_numpy(a).to(dev) for a in _kitti_K(height, width, n))
    T = torch.from_numpy(_pose_4x4(rng, n)).to(dev)
    coords = reproject_coords(depth[:, 0], invK, K, T).contiguous()
    return img, coords


def check_warp(dev, rng, opt=SHIPPED_B, batch=TRAIN_BATCH):
    """Kernel D, forward and coordinate gradient, against its plain
    version (torch gathers, autograd for the gradient) at one branch's
    warp of the training step: [24, 192, 640, 3] (2 frames x B=12; stage
    2: [24, 192, 512, 3]; a --grad_accum 2 microbatch: [12, 192, 640,
    3]), f32."""
    import torch
    import torch.nn.functional as F

    from ppeadepth_tpu_torch.kernels.warp import (
        coords_grad, warp_border, warp_border_plain)

    n, height, width = 2 * batch, opt.height, opt.width
    img, coords = _warp_inputs(dev, rng, n, height, width)
    g = torch.from_numpy(rng.randn(n, height, width, 3).astype("float32")).to(dev)
    lim = torch.tensor([1.0, 1.0], device=dev)
    out_of_range = (coords.abs() > lim).any(-1).float().mean().item()

    c = coords.clone().requires_grad_(True)
    out = warp_border(img, c)
    out.backward(g)
    torch.cuda.synchronize()
    cp = coords.clone().requires_grad_(True)
    ref = warp_border_plain(img, cp)
    ref.backward(g)
    fwd_err = (out.detach() - ref.detach()).abs().max().item()
    bwd_err = (c.grad - cp.grad).abs().max().item()
    bwd_peak = cp.grad.abs().max().item()
    tag = f"kernel D  [{n},{height},{width},3]"
    print(f"{tag}: {out_of_range:.4f} of the samples out of range; forward "
          f"max|d|={fwd_err:.3e} (tol {D_FWD_TOL:g}); coordinate gradient "
          f"max|d|={bwd_err:.3e} max|ref|={bwd_peak:.3e} (tol {D_BWD_REL_TOL:g} "
          f"x max|ref|)")
    if not (fwd_err <= D_FWD_TOL and bwd_err <= D_BWD_REL_TOL * bwd_peak):
        raise AssertionError(f"kernel D disagrees: {fwd_err}, {bwd_err}")

    # plain and library timings: the image takes no gradient, as in the loss
    cl = coords.clone().requires_grad_(True)
    img_nchw = img.permute(0, 3, 1, 2)

    def library_fwd():
        return F.grid_sample(img_nchw, cl, mode="bilinear",
                             padding_mode="border", align_corners=True)

    lib_out = library_fwd()
    ref_out = warp_border_plain(img, cp)
    g_nchw = g.permute(0, 3, 1, 2)
    results = {}
    for phase, plain, kernel, library in (
            ("forward",
             lambda: warp_border_plain(img, coords),
             lambda: warp_border(img, coords),
             library_fwd),
            ("backward",
             lambda: torch.autograd.grad(ref_out, cp, g, retain_graph=True),
             lambda: coords_grad(img, coords, g),
             lambda: torch.autograd.grad(lib_out, cl, g_nchw, retain_graph=True))):
        pl, kk = _time_pair(plain, kernel, 20)
        lib, _ = _time_pair(library, kernel, 20)
        nbytes, flop = _warp_work(n, height, width, phase)
        bnd, by = _bound_ms(nbytes, flop, F32_FLOP_PER_S)
        print(f"{tag} {phase}: {kk:.4f} ms/call ({nbytes / kk / 1e9:.3f} TB/s of "
              f"{nbytes / 1e6:.1f} MB), plain (torch gathers) {pl:.4f} ms, "
              f"F.grid_sample {lib:.4f} ms, bound {bnd:.4f} ms ({by})")
        results[phase] = dict(ms=kk, plain_ms=pl, library_ms=lib, bound_ms=bnd,
                              bound_by=by)
    results["forward"]["max_abs_err"] = fwd_err
    results["backward"]["max_abs_err"] = bwd_err
    return results


def _warp_work(n, height, width, phase):
    """(bytes, f32 operations) of one kernel D call on n images: the
    forward reads coordinates and image and writes the output, ~30
    operations a pixel; the backward also reads the output gradient and
    writes the coordinate gradient, ~45 a pixel."""
    pix = n * height * width
    if phase == "forward":
        return 4 * pix * (2 + 3 + 3), 30 * pix
    return 4 * pix * (2 + 3 + 3 + 2), 45 * pix


def time_warp(dev, rng, sweep):
    """`--kernel D`: at one branch's warp, [24, 192, 640, 3], the device
    time per launch (`_device_us`) of kernel D's forward and backward
    beside the library call's (`F.grid_sample`; its backward
    `aten.grid_sampler_2d_backward` with the image gradient off, as in the
    loss), the plain version's (CUDA events, autograd) and the bound. With
    `sweep`, also a plain copy of the output's bytes (`out.clone`)."""
    import torch
    import torch.nn.functional as F

    from ppeadepth_tpu_torch.kernels.warp import (
        coords_grad, warp_border, warp_border_plain)

    n, height, width = 2 * TRAIN_BATCH, SHIPPED_B.height, SHIPPED_B.width
    img, coords = _warp_inputs(dev, rng, n, height, width)
    g = torch.from_numpy(rng.randn(n, height, width, 3).astype("float32")).to(dev)
    img_nchw, g_nchw = img.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    cp = coords.clone().requires_grad_(True)
    ref = warp_border_plain(img, cp)  # a graph the timed backward can reuse
    tag = f"kernel D  [{n},{height},{width},3]"
    rows = {}
    for phase, plain, kernel, library in (
            ("forward",
             lambda: warp_border_plain(img, coords),
             lambda: warp_border(img, coords),
             lambda: F.grid_sample(img_nchw, coords, mode="bilinear",
                                   padding_mode="border", align_corners=True)),
            ("backward",
             lambda: torch.autograd.grad(ref, cp, g, retain_graph=True),
             lambda: coords_grad(img, coords, g),
             lambda: torch.ops.aten.grid_sampler_2d_backward(
                 g_nchw, img_nchw, coords, 0, 1, True, [False, True]))):
        us, lib = _device_us(kernel), _device_us(library)
        (pl,) = _time_turns([plain], 20)
        nbytes, flop = _warp_work(n, height, width, phase)
        bnd, by = _bound_ms(nbytes, flop, F32_FLOP_PER_S)
        print(f"{tag} {phase} launch: {us:.2f} us ({nbytes / us / 1e6:.3f} TB/s "
              f"of {nbytes / 1e6:.1f} MB, {100 * bnd * 1e3 / us:.1f} % of the "
              f"bound), library {lib:.2f} us (x{lib / us:.2f}); plain (torch "
              f"gathers, CUDA events) {pl * 1e3:.2f} us, bound "
              f"{bnd * 1e3:.2f} us ({by})")
        rows[phase] = dict(us=us, library_us=lib, plain_us=pl * 1e3,
                           bound_us=bnd * 1e3, bound_by=by)
    if sweep:
        out = warp_border(img, coords)
        copy = _device_us(out.clone)
        print(f"kernel D sweep: a copy of the forward's output (out.clone) "
              f"{copy:.2f} us, the forward {rows['forward']['us']:.2f} us "
              f"(x{rows['forward']['us'] / copy:.2f})")
        rows["copy_us"] = copy
    return rows


def _train_lk_calls(opt):
    """(C, H, W, k, forward calls, dx calls) of the large-kernel convs in
    one training step: every block's large and small kernel in the teacher
    and in the student's current-frame pass (forward and dx), and the
    student's lookup pass through stage 0 (forward only, no gradient)."""
    from ppeadepth_tpu_torch.models.replknet import REPLK_CONFIGS

    small = REPLK_CONFIGS[opt.rep_size]["small_kernel"]
    calls = []
    for i, (C, H, W, k, blocks) in enumerate(_stage_shapes(opt)):
        lookup = blocks if i == 0 else 0
        for kk in (k, small):  # lkb_origin and small_conv
            calls.append((C, H, W, kk, 2 * blocks + lookup, 2 * blocks))
    return calls


def check_lk_train(dev, rng, opt=TRAIN_B, batch=TRAIN_BATCH):
    """Kernel #2, the training large-kernel conv: kernel A without bias
    (forward) and on the flipped kernel (dx, through the autograd
    Function), against its plain version (cuDNN in f32, TF32 off) at each
    conv shape of the training step of `opt` (stage 1 at 640x192, stage 2
    at 512x192) at B=12 (or `batch`: 6, a --grad_accum 2 microbatch), in
    f32 and bf16. Times and
    bounds are per training step in bf16 (the main path), summed over its
    calls; the library yardstick is cuDNN's depthwise `F.conv2d` forward
    and `torch.nn.grad.conv2d_input`."""
    import torch

    from ppeadepth_tpu_torch.kernels.lk_conv import (
        _input_grad, depthwise_plain, lk_depthwise, lk_depthwise_train)

    worst, step = 0.0, {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    bound, f32 = _Bound(), {"ms": 0.0, "plain_ms": 0.0}
    for C, H, W, k, n_fwd, n_dx in _train_lk_calls(opt):
        for dtype in (torch.float32, torch.bfloat16):
            def t(shape, scale):
                return torch.from_numpy((rng.randn(*shape) * scale).astype(
                    "float32")).to(dev).to(dtype)

            x = t((batch, H, W, C), 1.0).permute(0, 3, 1, 2)
            g = t((batch, H, W, C), 1.0).permute(0, 3, 1, 2)
            w = t((C, 1, k, k), 1.0 / k)
            wf = w.flip(-1, -2).contiguous()
            xg = x.detach().requires_grad_(True)
            y = lk_depthwise_train(xg, w)
            y.backward(g)
            torch.cuda.synchronize()
            tol = A_REL_TOL if dtype == torch.bfloat16 else A_F32_REL_TOL
            tag = f"kernel #2 [{batch},{H},{W},{C}] k={k} {str(dtype)[6:]}"
            errs = []
            for name, got, ref in (
                    ("forward", y, depthwise_plain(x.float(), w.float())),
                    ("dx", xg.grad, depthwise_plain(g.float(), wf.float()))):
                err = (got.float() - ref).abs().max().item()
                peak = ref.abs().max().item()
                errs.append(f"{name} max|d|={err:.3e} max|ref|={peak:.3e}")
                if not err <= tol * peak:
                    raise AssertionError(f"{tag} {name} disagrees: {err} > {tol} x {peak}")
                worst = max(worst, err)
            print(f"{tag}: {'; '.join(errs)} (tol {tol:g} x max|ref|)")
            p_f, k_f = _time_pair(lambda: depthwise_plain(x, w),
                                  lambda: lk_depthwise(x, w), 10)
            p_d, k_d = _time_pair(lambda: depthwise_plain(g, wf),
                                  lambda: _input_grad(g, w), 10)
            lib_d, _ = _time_pair(
                lambda: torch.nn.grad.conv2d_input(x.shape, w, g, padding=k // 2,
                                                   groups=C),
                lambda: _input_grad(g, w), 10)
            bnd, by, rate = _lk_bound_ms(batch, H, W, C, k, dtype)
            print(f"{tag}: forward {k_f:.4f} ms (plain/cuDNN {p_f:.4f}), dx "
                  f"{k_d:.4f} ms (plain {p_d:.4f}, conv2d_input {lib_d:.4f}), "
                  f"bound {bnd:.4f} ms ({by}, {rate}) each; x{n_fwd} forward, "
                  f"x{n_dx} dx per step")
            if dtype == torch.bfloat16:
                step["ms"] += k_f * n_fwd + k_d * n_dx
                step["plain_ms"] += p_f * n_fwd + p_d * n_dx
                step["library_ms"] += p_f * n_fwd + lib_d * n_dx
                bound.add(bnd, by, n_fwd + n_dx)
            else:
                f32["ms"] += k_f * n_fwd + k_d * n_dx
                f32["plain_ms"] += p_f * n_fwd + p_d * n_dx
    print(f"kernel #2 per training step of B={batch} (bf16, {opt.width}x{opt.height}): "
          f"{step['ms']:.3f} ms, plain "
          f"{step['plain_ms']:.3f} ms, bound {bound.ms:.3f} ms; in f32 "
          f"{f32['ms']:.3f} ms, plain {f32['plain_ms']:.3f} ms")
    return dict(max_abs_err=worst, bound_ms=bound.ms, bound_by=bound.by,
                f32_ms=f32["ms"], f32_plain_ms=f32["plain_ms"], **step)


def _random_state_dict(opt):
    """Seeded random weights of the whole RepDepth in training form.

    Conv/linear weights come from `init_weights`; adapter `D_fc2` weights
    are drawn from a numpy seed (not zero) so the adapter branches count
    (0.05 N for a Linear, 0.05 / 3 N for a Conv3x3 of the same hidden
    width).
    BN running statistics are then calibrated by one train-mode pass of
    seeded random images through each network's own forward (teacher,
    student with a fixed pose, pose net), as a trained network's statistics
    match its own activations: with arbitrary statistics each eval-mode
    residual block scales its input, and the 36 blocks of RepLKNet-31B grow
    activations ~1000x, where bf16 and f32 then disagree for reasons that
    are not the kernels'. For the same reason the last BN scale of every
    residual branch (`pw2.bn.weight`) is drawn small, as in trained residual
    nets whose branches add small updates to the trunk; with unit scales the
    random 36-block net amplifies bf16 rounding chaotically. Finally the
    statistics are perturbed from the numpy seed, so the BN folding is
    exercised with non-trivial values."""
    import numpy as np
    import torch

    from ppeadepth_tpu_torch.models import RepDepth, init_weights

    # drop path off: the calibration passes run in train mode
    model = RepDepth(opt.replace(drop_path_rate=0.0))
    init_weights(model, torch.Generator().manual_seed(SEED))
    rng = np.random.RandomState(SEED)

    def draw(shape, scale):
        return torch.from_numpy(rng.randn(*shape).astype("float32") * scale)

    with torch.no_grad():
        for name, p in model.named_parameters():
            if "D_fc2" in name and name.endswith("weight"):
                # 0.05 for a Linear; a Conv3x3 over the same hidden width
                # a third of it, so each tap set adds what a Linear adds
                p.copy_(draw(p.shape, 0.05 * (p.shape[1] / p[0].numel()) ** 0.5))
            elif name.endswith("pw2.bn.weight"):
                p.copy_(torch.from_numpy(
                    rng.rand(*p.shape).astype("float32") * 0.05 + 0.05))
        bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
        for m in bns:
            m.reset_running_stats()
            m.momentum = None  # one pass: running stats = batch stats
        calib = torch.from_numpy(
            rng.rand(2, 3, opt.height, opt.width).astype("float32")
        ).contiguous(memory_format=torch.channels_last)
        lookup = torch.roll(calib, (2, 5), (2, 3))
        K, invK = (torch.from_numpy(a) for a in
                   _kitti_K(opt.height // 4, opt.width // 4, 2))
        model.train()
        model.forward_mono(calib)
        model.pose_pair(lookup, calib, invert=True)
        model.forward_multi(calib, lookup[:, None],
                            torch.from_numpy(_pose_4x4(rng, 2))[:, None],
                            K, invK, *DEPTH_BINS)
        model.eval()
        for m in bns:
            m.momentum = 0.1
            std = m.running_var.sqrt()
            m.running_mean += draw(std.shape, 0.05) * std
            m.running_var *= torch.from_numpy(
                rng.rand(*std.shape).astype("float32") * 0.4 + 0.8)
    return model.state_dict()


def _check_depths(depths, opt, tag):
    import numpy as np

    for d in depths:
        if d.shape != (BATCH, opt.height, opt.width):
            raise AssertionError(f"{tag}: depth shape {d.shape}")
        if not np.isfinite(d).all():
            raise AssertionError(f"{tag}: non-finite depth")
        if d.min() < opt.min_depth * (1 - 1e-3) or d.max() > opt.max_depth * (1 + 1e-3):
            raise AssertionError(f"{tag}: depth outside [{opt.min_depth}, "
                                 f"{opt.max_depth}]: {d.min()} .. {d.max()}")
    print(f"{tag}: depth shape {depths[0].shape}, finite, in "
          f"[{min(d.min() for d in depths):.4f}, "
          f"{max(d.max() for d in depths):.4f}]")


def _check_counts(counts, expected, tag):
    print(f"{tag}: launches {counts}")
    for name, n in expected.items():
        if counts[name] != n:
            raise AssertionError(f"{tag}: {counts[name]} {name} launches, "
                                 f"expected {n}")


def _compare_disp(depth, ref, opt, tag, plain=None):
    """|d disparity| of the card's bf16 answer against the CPU f32 one,
    mean within DISP_MEAN_TOL or, given `plain` (the same bf16 forward by
    the plain versions on the CPU), within BF16_PLAIN_MARGIN x its mean."""
    import numpy as np

    def disp(d):
        lo, hi = 1.0 / opt.max_depth, 1.0 / opt.min_depth
        return (1.0 / d - lo) / (hi - lo)

    dd = np.abs(disp(depth) - disp(ref))
    mean_tol = DISP_MEAN_TOL
    if plain is not None:
        dp = np.abs(disp(plain) - disp(ref))
        mean_tol = BF16_PLAIN_MARGIN * dp.mean()
        print(f"{tag}: bf16 plain versions on the CPU: |d disp| vs CPU f32 "
              f"mean {dp.mean():.3e} max {dp.max():.3e}")
    print(f"{tag}: |d disp| vs CPU f32 mean {dd.mean():.3e} max {dd.max():.3e} "
          f"(tol {mean_tol:.3e} / {DISP_MAX_TOL:g}); disp range "
          f"[{disp(ref).min():.4f}, {disp(ref).max():.4f}]")
    if not (dd.mean() <= mean_tol and dd.max() <= DISP_MAX_TOL):
        raise AssertionError(f"{tag}: card forward disagrees with the CPU forward")


def _latency(fn, requests, tag, opt=SHIPPED_B):
    """Median host wall of 10 calls, which return host numpy (so the device
    work is finished)."""
    import numpy as np

    times = []
    for i in range(10):
        t0 = time.perf_counter()
        fn(*requests[i % len(requests)])
        times.append(time.perf_counter() - t0)
    med = float(np.median(times)) * 1e3
    print(f"{tag} B={BATCH} {opt.width}x{opt.height} bf16: median {med:.3f} ms/batch "
          f"({BATCH / med * 1e3:.2f} images/s), all "
          f"{[round(t * 1e3, 3) for t in times]} ms")
    return med


def serve_teacher(sess, cpu, opt, requests, tag="teacher", plain=None):
    """Answer the teacher `requests` on the card through the kernels; check
    the outputs, the launch counts and agreement with the CPU f32
    forward (`_compare_disp`; `plain`: a bf16 session on the CPU)."""
    import torch

    from ppeadepth_tpu_torch import kernels

    blocks = sum(s[4] for s in _stage_shapes())
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    depths = [sess.predict_depth(img) for img, _ in requests]
    counts = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    n = len(requests)
    _check_counts(counts, {"lk_dwconv": blocks * n, "ffn_fused": blocks * n,
                           "plane_sweep": 0},
                  f"{tag}: {n} requests of B={BATCH}")
    _check_depths(depths, opt, tag)
    t0 = time.perf_counter()
    ref = cpu.predict_depth(requests[0][0][:1])
    print(f"{tag}: CPU f32 forward of one image in {time.perf_counter() - t0:.2f} s")
    _compare_disp(depths[0][:1], ref, opt, tag, None if plain is None
                  else plain.predict_depth(requests[0][0][:1]))
    _latency(lambda img, _: sess.predict_depth(img), requests,
             f"{tag}: predict_depth", opt)
    print(f"{tag}: peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    return counts


def serve_student(sess, cpu, opt, requests, tag="student", plain=None):
    """Answer the student `requests` (current frame + previous frame) on
    the card; check the outputs, the launch counts (kernel C once, or under
    --dyn_cv never and the dyn volume once; kernels A and B on stage 0
    twice and stages 1-3 once) and agreement with the CPU f32 forward
    (`_compare_disp`; `plain`: a bf16 session on the CPU)."""
    import torch

    from ppeadepth_tpu_torch import kernels

    blocks = sum(s[4] for s in _stage_shapes()) + _stage_shapes()[0][4]
    K, invK = _kitti_K(opt.height // 4, opt.width // 4, BATCH)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with _DynCalls() as dyn:
        depths = [sess.predict_depth_multi(img, lk, K, invK)
                  for img, lk in requests]
    counts = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    n = len(requests)
    _check_counts(counts, {"lk_dwconv": blocks * n, "ffn_fused": blocks * n,
                           "plane_sweep": 0 if opt.dyn_cv else n},
                  f"{tag}: {n} requests of B={BATCH}")
    if dyn.n != n * opt.dyn_cv:
        raise AssertionError(f"{tag}: {dyn.n} calls of the dyn volume")
    _check_depths(depths, opt, tag)
    img, lk = requests[0]
    t0 = time.perf_counter()
    ref = cpu.predict_depth_multi(img[:1], lk[:1], K[:1], invK[:1])
    print(f"{tag}: CPU f32 forward of one image in {time.perf_counter() - t0:.2f} s")
    _compare_disp(depths[0][:1], ref, opt, tag, None if plain is None
                  else plain.predict_depth_multi(img[:1], lk[:1], K[:1], invK[:1]))
    _latency(lambda img, lk: sess.predict_depth_multi(img, lk, K, invK),
             requests, f"{tag}: predict_depth_multi", opt)
    print(f"{tag}: peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    return counts


def serve_pose(sess, cpu, requests):
    """`predict_pose` on REQUESTS pairs: a rigid transform, launching none
    of the kernels, equal to the CPU f32 result."""
    import numpy as np

    from ppeadepth_tpu_torch import kernels

    kernels.reset_launch_counts()
    poses = [sess.predict_pose(lk, img) for img, lk in requests]
    counts = dict(kernels.launch_counts)
    _check_counts(counts, {k: 0 for k in counts}, f"pose: {REQUESTS} pairs")
    worst, ortho = 0.0, 0.0
    for T, (img, lk) in zip(poses, requests):
        if T.shape != (BATCH, 4, 4) or not np.isfinite(T).all():
            raise AssertionError(f"pose: shape {T.shape} or non-finite")
        if not (T[:, 3] == np.array([0, 0, 0, 1], np.float32)).all():
            raise AssertionError("pose: last row is not [0, 0, 0, 1]")
        R = T[:, :3, :3].astype(np.float64)
        ortho = max(ortho, np.abs(R @ R.transpose(0, 2, 1) - np.eye(3)).max())
        worst = max(worst, np.abs(T - cpu.predict_pose(lk, img)).max())
    print(f"pose: [B,4,4] rigid, max |R R^T - I| {ortho:.3e} (tol 1e-5); "
          f"max |d| vs CPU f32 {worst:.3e} (tol {POSE_TOL:g}); translation "
          f"norm of the first pair {np.linalg.norm(poses[0][:, :3, 3], axis=1).mean():.4e}")
    if not (ortho <= 1e-5 and worst <= POSE_TOL):
        raise AssertionError("pose: not orthonormal or disagrees with the CPU")
    return counts


def _train_batch(rng, batch, opt, device=None):
    """A training batch (the JAX batch dict) with real motion: frame 0 is
    a smooth random texture with fine noise, frames -1 and +1 shifted
    copies of it, as the serving requests, under --dyn_cv with black
    patches (`_occlude`); KITTI intrinsics at scales 0 and 2. numpy
    arrays, or tensors on `device`."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    H, W = opt.height, opt.width
    coarse = torch.from_numpy(rng.rand(batch, 3, H // 8, W // 8).astype("float32"))
    base = F.interpolate(coarse, size=(H, W), mode="bilinear", align_corners=False)
    base = (0.8 * base.permute(0, 2, 3, 1).numpy()
            + 0.2 * rng.rand(batch, H, W, 3).astype("float32"))
    frames = {0: base, -1: np.roll(base, (2, 5), (1, 2)),
              1: np.roll(base, (-2, -5), (1, 2))}
    if opt.dyn_cv:
        frames = {f: _occlude(rng, img) if f else img for f, img in frames.items()}
    out = {}
    for f, img in frames.items():
        out[("color", f, 0)] = out[("color_aug", f, 0)] = np.ascontiguousarray(img)
    for sc in (0, 2):
        out[("K", sc)], out[("inv_K", sc)] = _kitti_K(H >> sc, W >> sc, batch)
    if device is not None:
        out = {k: torch.from_numpy(v).to(device) for k, v in out.items()}
    return out


def _train_setup(sd, opt, device):
    """(model, state, step) of the port's training step on `device`, from
    the state_dict `sd`."""
    import torch

    from ppeadepth_tpu_torch.models import RepDepth
    from ppeadepth_tpu_torch.train.schedule import make_optimizer
    from ppeadepth_tpu_torch.train.step import create_train_state, make_train_step

    model = RepDepth(opt)
    model.load_state_dict(sd, strict=True)
    state = create_train_state(
        model, opt, device=device,
        generator=torch.Generator(device).manual_seed(SEED))
    optim, sched = make_optimizer(
        [p for p in model.parameters() if p.requires_grad], opt.learning_rate,
        steps_per_epoch=1000, step_size_epochs=opt.scheduler_step_size)
    return model, state, make_train_step(model, opt, optim, sched)


def train_parity(sd, dev, opt=TRAIN_B, tag="parity", batch=PARITY_BATCH):
    """One f32 training step of `opt` (stage 1, stage 2, or under
    --grad_accum) on `dev` against the same step on the CPU: the same
    weights, batch (B=PARITY_BATCH, or `batch`) and draws (matching
    augmentation from fixed uniforms, drop path off; microbatch i takes
    the draws of items i::N). Compares the loss, every metric and the
    concatenated trainable gradient."""
    import numpy as np
    import torch

    from ppeadepth_tpu_torch.train.step import StepDraws

    opt = opt.replace(compute_dtype="float32", drop_path_rate=0.0)
    n, N = batch, opt.grad_accum
    batch = _train_batch(np.random.RandomState(SEED + 2), n, opt)
    rng = np.random.RandomState(SEED + 3)
    u = np.linspace(0.1, 0.9, n).astype("float32")
    noise = [rng.randn(n, opt.height, opt.width, 1).astype("float32")
             for _ in range(2)]
    res = {}
    for device in (dev.type, "cpu"):
        model, state, step = _train_setup(sd, opt, device)
        draws = [StepDraws(*(torch.from_numpy(a[i::N]).to(device)
                             for a in (u, *noise))) for i in range(N)]
        t0 = time.perf_counter()
        _, metrics = step(state, batch, draws)
        grads = torch.cat([p.grad.flatten().float().cpu()
                           for p in model.parameters() if p.requires_grad])
        res[device] = ({k: v.item() for k, v in metrics.items()}, grads)
        print(f"{tag}: f32 step B={n} (grad_accum {N}) {opt.width}x{opt.height} on "
              f"{device} in {time.perf_counter() - t0:.2f} s (first call)")
        del model, step
    (m_gpu, g_gpu), (m_cpu, g_cpu) = res[dev.type], res["cpu"]
    worst = max(abs(m_gpu[k] - m_cpu[k]) for k in m_cpu if "depth_bins" not in k)
    bins = max(abs(m_gpu[k] / m_cpu[k] - 1) for k in m_cpu if "depth_bins" in k)
    rel = ((g_gpu - g_cpu).norm() / g_cpu.norm()).item()
    print(f"{tag}: metrics card {m_gpu}")
    print(f"{tag}: metrics CPU  {m_cpu}")
    print(f"{tag}: max |d metric| {worst:.3e} (tol {PARITY_METRIC_TOL:g}), depth "
          f"bins rel {bins:.3e} (tol {PARITY_BIN_REL:g}), trainable gradient "
          f"({g_cpu.numel()} entries) relative L2 {rel:.3e} (tol {PARITY_GRAD_L2:g})")
    if not (worst <= PARITY_METRIC_TOL and bins <= PARITY_BIN_REL
            and rel <= PARITY_GRAD_L2 and np.isfinite(rel)):
        raise AssertionError(f"{tag}: the card's f32 step disagrees with the CPU's")
    return dict(metric_err=worst, grad_rel_l2=rel)


def _expected_launches(opt):
    """Launches of each kernel in one training step of the configuration,
    per microbatch (--grad_accum N: N times): kernel D once per branch
    forward and backward; kernel A forward and dx as `_train_lk_calls`,
    of which in bf16 every large kernel's (k >= 13) on the banded instance
    and no small kernel's; the plane sweep once per lookup frame, or never
    under --dyn_cv (the DynamicDepth volume takes its place)."""
    calls = _train_lk_calls(opt)
    n = opt.grad_accum
    bf16 = opt.compute_dtype == "bfloat16"
    return {"warp_fwd": 2 * n, "warp_bwd": 2 * n, "ffn_fused": 0,
            "lk_dwconv": n * sum(c[4] for c in calls),
            "lk_dwconv_dx": n * sum(c[5] for c in calls),
            "lk_dwconv_banded": n * sum(c[4] + c[5] for c in calls if bf16 and c[3] >= 13),
            "plane_sweep": 0 if opt.dyn_cv else n * (len(opt.matching_ids) - 1)}


class _DynCalls:
    """Counts the calls of the DynamicDepth volume
    (`ops.cost_volume.plane_sweep_cost_volume_dyn`, which the matching
    encoder calls through its module) while the context is open."""

    def __enter__(self):
        from ppeadepth_tpu_torch.ops import cost_volume as CV

        self.n, self._fn = 0, CV.plane_sweep_cost_volume_dyn

        def counted(*a, **kw):
            self.n += 1
            return self._fn(*a, **kw)

        CV.plane_sweep_cost_volume_dyn = counted
        return self

    def __exit__(self, *exc):
        from ppeadepth_tpu_torch.ops import cost_volume as CV

        CV.plane_sweep_cost_volume_dyn = self._fn


def train_steps(sd, dev, profile, opt=TRAIN_B, tag="train", n_steps=TRAIN_STEPS,
                walls=None):
    """The training phase of `opt`: bf16 compute, B=TRAIN_BATCH, on `dev`
    (stage 1 at 640x192; stage 2 at 512x192 with the decoder adapters, and
    under --dyn_cv; either under --grad_accum): one warm-up step and
    `n_steps` timed ones, with the launch counts (and the dyn volume's
    calls), invariants and depth-bin EMA (of the microbatches' mean depth
    extremes) checked after each. Stage 2 also shows
    the dc freezing: the decoder trunks and heads frozen, and every
    parameter of each decoder's `adapter` and `deconv_adpt` moved.
    `walls[tag]` gets (median ms, peak bytes)."""
    import numpy as np
    import torch

    from ppeadepth_tpu_torch import kernels
    from ppeadepth_tpu_torch.core.geometry import disp_to_depth

    t0 = time.perf_counter()
    model, state, step = _train_setup(sd, opt, dev.type)
    print(f"{tag}: state built on the card in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    batch = _train_batch(np.random.RandomState(SEED + 4), TRAIN_BATCH, opt, dev)
    torch.cuda.synchronize()
    print(f"{tag}: batch B={TRAIN_BATCH} uploaded in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms (outside the timed steps)")
    named = dict(model.named_parameters())
    trainable = {n for n, p in named.items() if p.requires_grad}
    start = {n: p.detach().clone() for n, p in named.items()}
    stats0 = {n: b.clone() for n, b in model.named_buffers() if "running" in n}
    had_grad = set()
    depths = []
    hook = model.mono_depth.register_forward_hook(
        lambda m, args, out: depths.append(out[("disp", 0)].detach()))
    expected = _expected_launches(opt)
    times, losses = [], []
    torch.cuda.reset_peak_memory_stats()
    with _DynCalls() as dyn:
        for i in range(1 + n_steps):
            old_bins = (state.min_depth_bin.item(), state.max_depth_bin.item())
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n_dyn = dyn.n
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            counts = dict(kernels.launch_counts)
            m = {k: v.item() for k, v in metrics.items()}
            print(f"{tag} step {i}{' (warm-up)' if i == 0 else ''}: loss {m['loss']:.6f} "
                  f"(mono {m['mono/loss']:.6f}, multi {m['multi/loss']:.6f}, "
                  f"consistency {m['multi/consistency']:.6f}), {dt:.3f} ms host wall, "
                  f"launches {counts}")
            if counts != expected:
                raise AssertionError(f"{tag}: launches {counts}, expected {expected}")
            if dyn.n - n_dyn != int(opt.dyn_cv):
                raise AssertionError(f"{tag}: {dyn.n - n_dyn} calls of the "
                                     f"dyn volume, expected {int(opt.dyn_cv)}")
            if not all(np.isfinite(v) for v in m.values()):
                raise AssertionError(f"{tag}: non-finite metrics {m}")
            for n in trainable:
                g = named[n].grad
                if not torch.isfinite(g).all():
                    raise AssertionError(f"{tag}: non-finite gradient of {n}")
                if g.abs().max() > 0:
                    had_grad.add(n)
            ds = [disp_to_depth(x, opt.min_depth, opt.max_depth)[1]
                  for x in depths[-opt.grad_accum:]]
            dmin = max(opt.min_depth, np.mean(
                [d.amin(dim=(1, 2, 3)).mean().item() for d in ds]) * 0.9)
            dmax = np.mean([d.amax(dim=(1, 2, 3)).mean().item() for d in ds]) * 1.1
            want = (old_bins[0] * 0.99 + dmin * 0.01, old_bins[1] * 0.99 + dmax * 0.01)
            got = (m["depth_bins/min"], m["depth_bins/max"])
            if not np.allclose(got, want, rtol=1e-5):
                raise AssertionError(f"{tag}: depth bins {got}, EMA gives {want}")
            if i:
                times.append(dt)
                losses.append(m["loss"])
    hook.remove()
    peak = torch.cuda.max_memory_allocated()
    frozen_changed = [n for n in named if n not in trainable
                      and not torch.equal(named[n], start[n])]
    unmoved = [n for n in had_grad if torch.equal(named[n], start[n])]
    stats_moved = sum(not torch.equal(b, stats0[n])
                      for n, b in model.named_buffers() if n in stats0)
    med = float(np.median(times))
    print(f"{tag}: {len(trainable)} trainable tensors "
          f"({sum(named[n].numel() for n in trainable)} of "
          f"{sum(p.numel() for p in named.values())} parameters); "
          f"{len(trainable) - len(had_grad)} never had a non-zero gradient "
          f"{sorted(trainable - had_grad)[:8]}; {len(unmoved)} with a gradient "
          f"did not move; {len(frozen_changed)} frozen tensors changed; "
          f"{stats_moved} of {len(stats0)} BN running statistics moved")
    if frozen_changed or unmoved or stats_moved != len(stats0):
        raise AssertionError(f"{tag}: frozen changed {frozen_changed[:5]}, "
                             f"unmoved {unmoved[:5]}, stats moved {stats_moved}")
    if opt.dc:
        _check_dc_decoders(named, trainable, start, tag)
    print(f"{tag}: depth bins after {1 + n_steps} steps "
          f"[{state.min_depth_bin.item():.6f}, {state.max_depth_bin.item():.6f}]; "
          f"loss over the timed steps {[round(v, 6) for v in losses]}, "
          f"{'fell' if losses[-1] < losses[0] else 'did not fall'}")
    if walls is not None:
        walls[tag] = (med, peak)
    print(f"{tag} step B={TRAIN_BATCH} (grad_accum {opt.grad_accum}) "
          f"{opt.width}x{opt.height} bf16: median {med:.3f} ms/step "
          f"({TRAIN_BATCH / med * 1e3:.2f} images/s), all "
          f"{[round(t, 3) for t in times]} ms; peak device memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB)")
    if profile:
        profile_serving(f"{tag}_step", lambda: step(state, batch), [()])
    return counts


def _check_dc_decoders(named, trainable, start, tag):
    """Stage 2's freezing in each decoder: trunk and head frozen (and, as
    `train_steps` checked, bit-identical), only `adapter` and `deconv_adpt`
    trainable, and every one of their parameters moved."""
    import torch

    for dec in ("depth", "mono_depth"):
        mods = {n.split(".")[1] for n in named if n.startswith(dec + ".")}
        trained = sorted(n for n in trainable if n.startswith(dec + "."))
        moved = [n for n in trained if not torch.equal(named[n], start[n])]
        frozen = {n.split(".")[1] for n in named
                  if n.startswith(dec + ".") and n not in trainable}
        print(f"{tag}: {dec}: {len(trained)} trainable tensors "
              f"{sorted({n.split('.')[1] for n in trained})}, {len(moved)} moved; "
              f"frozen {sorted(frozen)}")
        if ({n.split(".")[1] for n in trained} != {"adapter", "deconv_adpt"}
                or frozen != mods - {"adapter", "deconv_adpt"}
                or not {"upconvs_0", "upconvs_1", "disp_convs"} <= frozen
                or len(moved) != len(trained)):
            raise AssertionError(f"{tag}: {dec} is not frozen as stage 2 "
                                 f"freezes it: trained {trained}, moved {moved}")


def _eval_lk_calls(opt, post_process=True, teacher=True):
    """(C, H, W, k, calls) of kernel A in one eval batch under --lk_backend
    pallas: the stem's stride-1 3x3 conv of every RepLKNet pass (current
    and lookup frames of each student forward, and the teacher), and every
    block's large and small kernel in each student forward (stage 0 twice)
    and in the teacher. Under "lax" the stem's entry is absent."""
    from ppeadepth_tpu_torch.models.replknet import REPLK_CONFIGS

    cfg = REPLK_CONFIGS[opt.rep_size]
    student = 2 if post_process else 1
    calls = [(cfg["channels"][0], opt.height // 2, opt.width // 2, 3,
              2 * student + teacher)]
    for i, (C, H, W, k, blocks) in enumerate(_stage_shapes(opt)):
        n = blocks * (student * (2 if i == 0 else 1) + teacher)
        calls += [(C, H, W, k, n), (C, H, W, cfg["small_kernel"], n)]
    return calls


def check_lk_pallas(dev, rng, opt=SHIPPED_B, n_test=N_TEST):
    """Kernel #3 (the Pallas `depthwise_conv2d_pallas`, kernel A here)
    against its plain version (cuDNN, TF32 off) at every conv shape of the
    eval forward of `opt` under --lk_backend pallas (KITTI 640x192: the
    stem's k=3 on 96x320 and each stage's large k and k=5; DDAD 320x480:
    stages of 80x120 down to 10x15), in f32 (the eval's compute) and bf16
    (validation under bf16 compute), at the eval batch and at the partial
    last batch of an eval of `n_test` images. Times and bounds are per f32
    eval batch of EVAL_BATCH (the sum over its calls); the library
    yardstick is the plain version, one cuDNN call."""
    import torch

    from ppeadepth_tpu_torch.kernels.lk_conv import depthwise_plain, lk_depthwise

    worst, tot, bound = 0.0, {"ms": 0.0, "plain_ms": 0.0}, _Bound()
    for C, H, W, k, calls in _eval_lk_calls(opt):
        for dtype in (torch.float32, torch.bfloat16):
            tol = LK3_F32_REL_TOL if dtype == torch.float32 else A_REL_TOL
            for B in (EVAL_BATCH, n_test % EVAL_BATCH):
                def t(shape, scale):
                    return torch.from_numpy((rng.randn(*shape) * scale).astype(
                        "float32")).to(dev).to(dtype)

                x = t((B, H, W, C), 1.0).permute(0, 3, 1, 2)
                w = t((C, 1, k, k), 1.0 / k)
                y = lk_depthwise(x, w)
                torch.cuda.synchronize()
                ref = depthwise_plain(x.float(), w.float())
                err = (y.float() - ref).abs().max().item()
                peak = ref.abs().max().item()
                tag = f"kernel #3 [{B},{H},{W},{C}] k={k} {str(dtype)[6:]}"
                print(f"{tag}: max|d|={err:.3e} max|ref|={peak:.3e} "
                      f"(tol {tol:g} x max|ref|)")
                if not err <= tol * peak:
                    raise AssertionError(f"{tag} disagrees: {err} > {tol} x {peak}")
                worst = max(worst, err)
                if B != EVAL_BATCH:
                    continue
                p, kk = _time_pair(lambda: depthwise_plain(x, w),
                                   lambda: lk_depthwise(x, w), 10)
                macs = _dw_macs(B, H, W, C, k)
                bnd, by = _bound_ms(x.element_size() * (2 * B * H * W * C + C * k * k),
                                    2 * macs, F32_FLOP_PER_S)
                print(f"{tag}: {kk:.4f} ms/call ({macs / kk / 1e9:.2f} T "
                      f"multiply-adds/s), plain (cuDNN) {p:.4f} ms/call, bound "
                      f"{bnd:.4f} ms ({by}), x{calls} per eval batch")
                if dtype == torch.float32:
                    tot["ms"] += kk * calls
                    tot["plain_ms"] += p * calls
                    bound.add(bnd, by, calls)
    print(f"kernel #3 per f32 eval batch of {EVAL_BATCH} at {opt.width}x"
          f"{opt.height} ({sum(c[4] for c in _eval_lk_calls(opt))} calls): "
          f"{tot['ms']:.3f} ms, plain (cuDNN) {tot['plain_ms']:.3f} ms, bound "
          f"{bound.ms:.3f} ms")
    return dict(max_abs_err=worst, bound_ms=bound.ms, bound_by=bound.by,
                library_ms=tot["plain_ms"], **tot)


KITTI_FOLDER = "2011_09_26/2011_09_26_drive_0001_sync"


def _kitti_set(root, rng):
    """A synthetic KITTI raw set under `root`, in the KITTI layout
    (kitti/<date>/<drive>/image_02/data/%010d.jpg, 375x1242): a smooth
    random texture shifted 3 px per frame, as a camera panning over a
    scene; split files of the split "smoke" (N_TRAIN training items, N_TEST
    test items) and a synthetic gt_depths.npz for its test items (smooth
    depths of 5-60 m at ~5 % of the pixels, as lidar leaves them)."""
    import os

    import numpy as np
    from PIL import Image

    n_frames = N_TRAIN + 2
    data = os.path.join(root, "kitti", KITTI_FOLDER, "image_02", "data")
    os.makedirs(data)
    base = rng.rand(375, 1242 + 3 * n_frames, 3) * 255
    for _ in range(3):
        base = (0.5 * base + 0.125 * (np.roll(base, 1, 0) + np.roll(base, -1, 0)
                                      + np.roll(base, 1, 1) + np.roll(base, -1, 1)))
    for f in range(n_frames):
        Image.fromarray(base[:, 3 * f:3 * f + 1242].astype(np.uint8)).save(
            os.path.join(data, f"{f:010d}.jpg"), quality=92)
    split = os.path.join(root, "splits", "smoke")
    os.makedirs(split)
    lines = [f"{KITTI_FOLDER} {i} l" for i in range(1, n_frames - 1)]
    with open(os.path.join(split, "train_files.txt"), "w") as fh:
        fh.write("\n".join(lines[:N_TRAIN]) + "\n")
    with open(os.path.join(split, "test_files.txt"), "w") as fh:
        fh.write("\n".join(lines[:N_TEST]) + "\n")
    yy, xx = np.mgrid[0:375, 0:1242] / np.array([375.0, 1242.0])[:, None, None]
    gt = []
    for i in range(N_TEST):
        depth = 5 + 55 * (0.5 + 0.5 * np.sin(3 * xx + i) * np.cos(2 * yy))
        gt.append(np.where(rng.rand(375, 1242) < 0.05, depth, 0).astype("float32"))
    np.savez(os.path.join(split, "gt_depths.npz"), data=np.stack(gt))


def _cli_args(extra=()):
    """The CLI flags of the shipped configuration on the synthetic set."""
    return ["--adapter", "--rep_size", "b", "--height", "192", "--width", "640",
            "--batch_size", str(EVAL_BATCH), "--data_path", "kitti",
            "--split", "smoke", "--eval_split", "smoke", "--num_workers", "8",
            *extra]


def _run_cli(args, steps, vals):
    """`python -m ppeadepth_tpu_torch.train <args>` in-process, with the
    launch counts and the peak memory statistic set to 0 just before it;
    each training step appends (start, end, the launches it added, its
    metrics, the step count it started from) to `steps`, each validation
    (start, end) to `vals`, and metrics.jsonl gets a record every LOG_EVERY
    steps. Returns (trainer, wall seconds, the run's counts)."""
    import torch

    from ppeadepth_tpu_torch import kernels
    from ppeadepth_tpu_torch.train import __main__ as cli
    from ppeadepth_tpu_torch.train import trainer as trainer_mod

    make_step, run_eval = trainer_mod.make_train_step, trainer_mod.evaluator.run_eval

    def counted_make_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(state, batch, draws=None):
            before = dict(kernels.launch_counts)
            start_step = state.step
            t0 = time.perf_counter()
            state, metrics = step(state, batch, draws)
            torch.cuda.synchronize()
            steps.append((t0, time.perf_counter(),
                          {k: n - before[k] for k, n in kernels.launch_counts.items()},
                          {k: v.item() for k, v in metrics.items()}, start_step))
            return state, metrics
        return run

    def timed_eval(*a, **kw):
        t0 = time.perf_counter()
        out = run_eval(*a, **kw)
        vals.append((t0, time.perf_counter()))
        return out

    trainer_mod.make_train_step = counted_make_step
    trainer_mod.evaluator.run_eval = timed_eval
    trainer_mod.LOG_EVERY = LOG_EVERY  # records within the short run
    try:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = cli.main(args)
        return trainer, time.perf_counter() - t0, dict(kernels.launch_counts)
    finally:
        trainer_mod.make_train_step = make_step
        trainer_mod.evaluator.run_eval = run_eval
        trainer_mod.LOG_EVERY = 50


def _check_cli_run(tag, opt, trainer, steps, counts, n_steps, validate_every,
                   n_test, log, name):
    """The checks of a training CLI run (`_run_cli`) of `opt`: each step's
    launches (`_expected_launches`) and finite metrics; n_steps steps; the
    run's launches, the steps' and per validation batch the student's once
    and the teacher's (kernel A 52 + 48 calls, kernel C once) over
    ceil(n_test / B) batches a validation; metrics.jsonl's train, val and
    val_mono records under their keys, finite; and the four files of each
    checkpoint. Returns the checkpoint folders under `log`."""
    import os

    import numpy as np

    from ppeadepth_tpu_torch.eval import metrics as M

    expected = _expected_launches(opt)
    for i, (_, _, c, m, _) in enumerate(steps):
        print(f"{tag} step {i + 1}: loss {m['loss']:.6f}, launches {c}")
        if c != expected:
            raise AssertionError(f"{tag}: step {i + 1} launches {c}, "
                                 f"expected {expected}")
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{tag}: non-finite metrics {m}")
    if len(steps) != n_steps or trainer.state.step != n_steps:
        raise AssertionError(f"{tag}: {len(steps)} steps, expected {n_steps}")
    n_val = n_steps // validate_every
    val_batches = n_val * -(-n_test // EVAL_BATCH)
    per_val = sum(c[4] for c in _eval_lk_calls(opt, False)[1:])
    _check_counts(counts, {
        "lk_dwconv": n_steps * expected["lk_dwconv"] + val_batches * per_val,
        "lk_dwconv_dx": n_steps * expected["lk_dwconv_dx"],
        "warp_fwd": 2 * n_steps, "warp_bwd": 2 * n_steps, "ffn_fused": 0,
        "plane_sweep": n_steps + val_batches},
        f"{tag}: {n_steps} steps and {n_val} validations")

    with open(os.path.join(log, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    train_keys = {"step", "prefix", *steps[0][3]}
    val_keys = {"step", "prefix", *M.METRIC_NAMES}
    for prefix, keys, n in (("train", train_keys, n_steps // LOG_EVERY),
                            ("val", val_keys, n_val), ("val_mono", val_keys, n_val)):
        got = [r for r in recs if r["prefix"] == prefix]
        if len(got) != n or any(set(r) != keys for r in got) or not all(
                np.isfinite(v) for r in got for k, v in r.items()
                if k not in ("step", "prefix")):
            raise AssertionError(f"{tag}: metrics.jsonl {prefix} records {got}")
    folders = [f"{name}_s{s}" for s in range(validate_every, n_steps + 1,
                                             validate_every)] + [f"{name}_final"]
    for folder in folders:
        for f in ("model.pth", "adam.pth", "track.json", "opt.json"):
            if not os.path.isfile(os.path.join(log, folder, f)):
                raise AssertionError(f"{tag}: {folder}/{f} missing")
    print(f"{tag}: metrics.jsonl holds {len(recs)} records (train, val, "
          f"val_mono), finite; checkpoints {folders} hold model.pth, "
          f"adam.pth, track.json, opt.json; validation records "
          f"{[r for r in recs if r['prefix'] == 'val']}")
    return folders


def train_cli(sd, dev):
    """`python -m ppeadepth_tpu_torch.train` in-process, from the current
    directory (the synthetic set): TRAIN_EPOCHS epochs of N_TRAIN items at
    B=12, bf16, validation and a checkpoint every VALIDATE_EVERY steps,
    from a seed checkpoint holding `sd` (calibrated random weights; no Adam
    state, so Adam starts fresh). The counts are set to 0 just before the
    run and read after it; each training step's launches are what it
    added to them.
    Returns (trainer, its final checkpoint folder, the run's counts)."""
    import os

    import torch

    os.makedirs("seed")
    torch.save(sd, os.path.join("seed", "model.pth"))
    args = _cli_args(["--compute_dtype", "bfloat16", "--weights_init", "scratch",
                      "--num_epochs", str(TRAIN_EPOCHS), "--validate_every",
                      str(VALIDATE_EVERY), "--log_dir", "ckpt", "--name", "smoke",
                      "--pytorch_random_seed", "0", "--load_weights_folder", "seed"])
    print("train CLI: python -m ppeadepth_tpu_torch.train " + " ".join(args))
    steps, vals = [], []
    trainer, wall, counts = _run_cli(args, steps, vals)
    peak = torch.cuda.max_memory_allocated()

    n_steps = TRAIN_EPOCHS * N_TRAIN // EVAL_BATCH
    log = os.path.join("ckpt", "smoke")
    _check_cli_run("train CLI", TRAIN_B, trainer, steps, counts, n_steps,
                   VALIDATE_EVERY, N_TEST, log, "smoke")

    rate = _loop_rate("train CLI", steps, vals, wall, peak)
    return trainer, os.path.join(log, "smoke_final"), counts, rate


def _loop_rate(tag, steps, vals, wall, peak):
    """Print and return the loop's rate (images/s) of a KITTI CLI run: a
    step and the wait for its batch, for steps that are not the first of
    an epoch and follow no validation."""
    per_epoch = N_TRAIN // EVAL_BATCH
    clean = [steps[i][1] - steps[i - 1][1] for i in range(1, len(steps))
             if i % per_epoch and not any(steps[i - 1][1] <= v0 < steps[i][0]
                                          for v0, _ in vals)]
    step_ms = [(e - s) * 1e3 for s, e, *_ in steps]
    rate = EVAL_BATCH * len(clean) / sum(clean)
    print(f"{tag} B={EVAL_BATCH} 640x192 bf16: loop {rate:.2f} images/s "
          f"({rate / EVAL_BATCH:.3f} steps/s) over "
          f"{len(clean)} steps with their loader wait (intervals "
          f"{[round(c * 1e3, 3) for c in clean]} ms); steps alone "
          f"{[round(t, 3) for t in step_ms]} ms; validations "
          f"{[round((e - s) * 1e3, 3) for s, e in vals]} ms; whole run "
          f"{wall:.2f} s; peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    return rate


def check_resume(trainer, folder):
    """A new Trainer with --load_weights_folder on the final checkpoint:
    parameters, BN statistics, Adam's state and schedule, depth bins and
    step equal the saved ones, and the trained ones, exactly."""
    import os

    import torch

    from ppeadepth_tpu_torch.options import parse_args
    from ppeadepth_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    resumed = Trainer(parse_args(_cli_args([
        "--compute_dtype", "bfloat16", "--log_dir", "ckpt", "--name", "resume",
        "--load_weights_folder", folder])))
    resumed.close()
    saved = torch.load(os.path.join(folder, "model.pth"), weights_only=True)
    adam = torch.load(os.path.join(folder, "adam.pth"), weights_only=True)
    bad = []
    for src, sd in (("saved", saved), ("trained", trainer.model.state_dict())):
        got = resumed.model.state_dict()
        bad += [f"{src}:{k}" for k in sd if not torch.equal(sd[k].cpu(), got[k].cpu())]
        if set(sd) != set(got):
            bad.append(f"{src}: key sets differ")
    for src, opt_sd in (("saved", adam["optimizer"]),
                        ("trained", trainer.optimizer.state_dict())):
        got = resumed.optimizer.state_dict()
        if opt_sd["param_groups"] != got["param_groups"] or set(opt_sd["state"]) != set(got["state"]):
            bad.append(f"{src}: Adam param groups or state keys")
        bad += [f"{src}: Adam {i}.{k}" for i, st in opt_sd["state"].items()
                for k, v in st.items() if not torch.equal(v.cpu(), got["state"][i][k].cpu())]
    if resumed.scheduler.state_dict() != adam["scheduler"]:
        bad.append("scheduler")
    for name in ("min_depth_bin", "max_depth_bin"):
        a, b = getattr(trainer.state, name), getattr(resumed.state, name)
        if not torch.equal(a, b):
            bad.append(f"{name} {a.item()} vs {b.item()}")
    if resumed.state.step != trainer.state.step:
        bad.append(f"step {resumed.state.step} vs {trainer.state.step}")
    n_adam = sum(len(st) for st in adam["optimizer"]["state"].values())
    print(f"resume: Trainer built from {folder} in {time.perf_counter() - t0:.2f} s; "
          f"{len(saved)} model entries, {n_adam} Adam tensors, scheduler, bins "
          f"[{resumed.state.min_depth_bin.item()}, {resumed.state.max_depth_bin.item()}] "
          f"and step {resumed.state.step} against the saved and trained ones: "
          f"{len(bad)} differ")
    if bad:
        raise AssertionError(f"resume: not exact: {bad[:10]}")


def _stage2_state_dict(sd, opt):
    """Stage 2's weights for its step phases: the stage-1 weights `sd`
    (calibrated random) and, in each decoder, the dec_id-1 adapter from
    `init_weights` with its D_fc2 and the deconv_adpt kernel drawn from a
    numpy seed (small, not zero, as `_random_state_dict` draws D_fc2), so
    every adapter parameter has a gradient from the first step."""
    import numpy as np
    import torch

    from ppeadepth_tpu_torch.models import init_weights
    from ppeadepth_tpu_torch.models.depth_decoder import DepthDecoderV2
    from ppeadepth_tpu_torch.models.replknet import num_ch_enc

    rng = np.random.RandomState(SEED + 6)
    out = dict(sd)
    for i, prefix in enumerate(("depth", "mono_depth")):
        dec = DepthDecoderV2(num_ch_enc(opt.rep_size), dc=True,
                             dec_id=opt.dec_id, dec_ratio=opt.dec_ratio)
        init_weights(dec, torch.Generator().manual_seed(SEED + i))
        for k, v in dec.state_dict().items():
            if f"{prefix}.{k}" in sd:
                continue
            if k.endswith("weight") and ("D_fc2" in k or "deconv_adpt" in k):
                v = torch.from_numpy(rng.randn(*v.shape).astype("float32") * 0.05)
            out[f"{prefix}.{k}"] = v
    return out


def _texture(rng, height, width):
    """A smooth random RGB texture [height, width, 3] in [0, 255]."""
    import numpy as np

    base = rng.rand(height, width, 3) * 255
    for _ in range(3):
        base = (0.5 * base + 0.125 * (np.roll(base, 1, 0) + np.roll(base, -1, 0)
                                      + np.roll(base, 1, 1) + np.roll(base, -1, 1)))
    return base


def _cityscapes_set(root, rng):
    """A synthetic CityScapes set under `root`: N_CS_TRAIN ManyDepth-
    preprocessed training triplets (cs/<city>/<frame>.jpg: frames -1, 0
    and +1 of 1024x384 side by side, a smooth random texture panning 3 px
    a frame, and <frame>_cam.txt); the `cityscapes_eval` layout of
    N_CS_TEST test frames (cs_eval/leftImg8bit/test/<city>/
    <frame>_leftImg8bit.png at 2048x1024, frame -2 panned 6 px in
    leftImg8bit_sequence/test, and the camera JSONs of
    camera_trainvaltest/camera/test); the split files of
    cityscapes_preprocessed; and splits/cityscapes/gt_depths/
    NNN_depth.npy of the test frames (1024x2048, smooth depths of 5-60 m
    at ~5 % of the pixels, as the disparity-derived GT leaves gaps)."""
    import os

    import numpy as np
    from PIL import Image

    train = os.path.join(root, "cs", CS_CITY)
    os.makedirs(train)
    base = _texture(rng, 384, 1024 + 3 * (N_CS_TRAIN + 2))
    cam = np.array([[1100.0, 0.0, 512.0, 0.0, 1100.0, 200.0, 0.0, 0.0, 1.0]])
    frames = [f"{CS_CITY}_{i:06d}_000019" for i in range(N_CS_TRAIN)]
    for i, frame in enumerate(frames):
        wide = np.concatenate([base[:, 3 * (i + j):3 * (i + j) + 1024]
                               for j in range(3)], 1)
        Image.fromarray(wide.astype(np.uint8)).save(
            os.path.join(train, f"{frame}.jpg"), quality=92)
        np.savetxt(os.path.join(train, f"{frame}_cam.txt"), cam, delimiter=",")

    ev = os.path.join(root, "cs_eval")
    dirs = [os.path.join(ev, k, "test", CS_CITY)
            for k in ("leftImg8bit", "leftImg8bit_sequence")]
    camera = os.path.join(ev, "camera_trainvaltest", "camera", "test", CS_CITY)
    gt_dir = os.path.join(root, "splits", "cityscapes", "gt_depths")
    for d in (*dirs, camera, gt_dir):
        os.makedirs(d)
    tests = [f"{CS_CITY}_{i:06d}_000019" for i in range(1000, 1000 + N_CS_TEST)]
    yy, xx = np.mgrid[0:1024, 0:2048] / np.array([1024.0, 2048.0])[:, None, None]
    intrinsic = {"fx": 2262.52, "fy": 2265.3017905988554, "u0": 1096.98,
                 "v0": 513.137}
    for i, frame in enumerate(tests):
        base = _texture(rng, 1024, 2048 + 6)
        prev = frame[:-6] + "000017"
        for d, name, off in ((dirs[0], frame, 6), (dirs[1], prev, 0)):
            Image.fromarray(base[:, off:off + 2048].astype(np.uint8)).save(
                os.path.join(d, f"{name}_leftImg8bit.png"), compress_level=1)
        with open(os.path.join(camera, f"{frame}_camera.json"), "w") as fh:
            json.dump({"intrinsic": intrinsic}, fh)
        depth = 5 + 55 * (0.5 + 0.5 * np.sin(3 * xx + i) * np.cos(2 * yy))
        np.save(os.path.join(gt_dir, f"{i:03d}_depth.npy"),
                np.where(rng.rand(1024, 2048) < 0.05, depth, 0).astype("float32"))
    split = os.path.join(root, "splits", "cityscapes_preprocessed")
    os.makedirs(split)
    for name, items in (("train", frames), ("test", tests)):
        with open(os.path.join(split, f"{name}_files.txt"), "w") as fh:
            fh.write("\n".join(f"{CS_CITY} {f}" for f in items) + "\n")


def _ddad_set(root, rng):
    """A synthetic DDAD set under `root`/ddad in the layout
    `data.ddad.DDADNpzDataset` reads (tools/export_ddad.py writes it):
    N_DDAD samples of 1936x1216 jpgs, frame 0 and frame -1 of a smooth
    random texture panning 6 px a sample and 4 px a frame
    (rgb/{idx}_{frame}.jpg), the native 3x3 intrinsics (calib/{idx}.npy),
    lidar-like GT of frame 0 (depth/{idx}.npy: smooth depths of 5-150 m,
    beyond KITTI's 80 m clamp, at ~5 % of the pixels) and val_index.txt."""
    import os

    import numpy as np
    from PIL import Image

    H, W = DDAD_RAW
    root = os.path.join(root, "ddad")
    for d in ("rgb", "calib", "depth"):
        os.makedirs(os.path.join(root, d))
    base = _texture(rng, H, W + 6 * N_DDAD + 4)
    K = np.array([[2000.0, 0, W / 2], [0, 2000.0, H / 2], [0, 0, 1]], "float32")
    yy, xx = np.mgrid[0:H, 0:W] / np.array([H, W], "float32")[:, None, None]
    for i in range(N_DDAD):
        for frame, off in ((0, 4), (-1, 0)):
            x0 = 6 * i + off
            Image.fromarray(base[:, x0:x0 + W].astype(np.uint8)).save(
                os.path.join(root, "rgb", f"{i}_{frame}.jpg"), quality=92)
        np.save(os.path.join(root, "calib", f"{i}.npy"), K)
        depth = 5 + 145 * (0.5 + 0.5 * np.sin(3 * xx + i) * np.cos(2 * yy))
        np.save(os.path.join(root, "depth", f"{i}.npy"),
                np.where(rng.rand(H, W) < 0.05, depth, 0).astype("float32"))
    with open(os.path.join(root, "val_index.txt"), "w") as fh:
        fh.write("\n".join(str(i) for i in range(N_DDAD)) + "\n")


def _ddad_args(extra=()):
    """The flags of `python -m ppeadepth_tpu_torch.evaluate_ddad` for the
    shipped network on the synthetic DDAD set (the forced 320x480)."""
    return ["--adapter", "--rep_size", "b", "--batch_size", str(EVAL_BATCH),
            "--data_path", "ddad", "--num_workers", "8", *extra]


def _cs_cli_args(extra=()):
    """The CLI flags of stage 2 on the synthetic CityScapes set: the
    --train_cs preset (192x512, the cityscapes_preprocessed split, the
    cityscapes eval split) and the dec_id-1 decoder adapters."""
    return ["--train_cs", "--dc", "--adapter", "--rep_size", "b",
            "--batch_size", str(EVAL_BATCH), "--data_path", "cs",
            "--cs_eval_path", "cs_eval", "--num_workers", "8", *extra]


def train_cli_stage2(warm_start):
    """Stage 2 through the CLI, in-process, on the synthetic CityScapes set
    (`python -m ppeadepth_tpu_torch.train --train_cs --dc --adapter --ktf
    --learning_rate 1e-5 --load_weights_folder <warm_start>`, the KITTI
    phase's final checkpoint): CS_EPOCHS epochs of N_CS_TRAIN triplets at
    B=12, bf16, a validation on the cityscapes_eval layout and a checkpoint
    every CS_VALIDATE_EVERY steps. Checks the preset's size, that stage 2
    starts at step 0 (not at the warm start's step) and runs every step of
    its epochs, each step's launches (stage 1's), the whole run's, the
    validation records, every frozen parameter against the warm start's,
    and the checkpoints. Returns (the final checkpoint folder, the run's
    counts)."""
    import os

    import torch

    from ppeadepth_tpu_torch.ckpt import io as ckpt_io

    args = _cs_cli_args(["--ktf", "--learning_rate", "1e-5",
                         "--load_weights_folder", warm_start,
                         "--compute_dtype", "bfloat16",
                         "--num_epochs", str(CS_EPOCHS),
                         "--validate_every", str(CS_VALIDATE_EVERY),
                         "--log_dir", "ckpt", "--name", "cs",
                         "--pytorch_random_seed", "0"])
    print("stage-2 CLI: python -m ppeadepth_tpu_torch.train " + " ".join(args))
    warm_step = ckpt_io.read_track(warm_start)["step"]
    steps, vals = [], []
    trainer, wall, counts = _run_cli(args, steps, vals)
    peak = torch.cuda.max_memory_allocated()
    opt = trainer.opt

    n_steps = CS_EPOCHS * N_CS_TRAIN // EVAL_BATCH
    log = os.path.join("ckpt", "cs")
    folders = _check_cli_run("stage-2 CLI", STAGE2_B, trainer, steps, counts,
                             n_steps, CS_VALIDATE_EVERY, N_CS_TEST, log, "cs")
    starts = [st[4] for st in steps]
    print(f"stage-2 CLI: {opt.dataset} at {opt.width}x{opt.height}; the warm "
          f"start's track.json step {warm_step}; the steps started from "
          f"{starts}, the run ended at step {trainer.state.step}")
    if ((opt.height, opt.width) != (STAGE2_B.height, STAGE2_B.width)
            or opt.dataset != "cityscapes_preprocessed"):
        raise AssertionError(f"stage-2 CLI: preset not applied: {opt.dataset} "
                             f"{opt.width}x{opt.height}")
    if starts != list(range(n_steps)):
        raise AssertionError(f"stage-2 CLI: steps started from {starts}, "
                             f"expected 0 .. {n_steps - 1}")

    warm = torch.load(os.path.join(warm_start, "model.pth"), weights_only=True)
    named = dict(trainer.model.named_parameters())
    frozen = [n for n, p in named.items() if not p.requires_grad]
    changed = [n for n in frozen if not torch.equal(named[n].detach().cpu(), warm[n])]
    new = sorted(n for n in named if n not in warm)
    nonzero = [n for n in new if named[n].detach().abs().max() > 0]
    print(f"stage-2 CLI: {len(frozen)} frozen tensors, {len(changed)} differ from "
          f"the warm start; {len(new)} stage-2 tensors new to it, non-zero after "
          f"the run: {nonzero}")
    stage2_names = {f"{d}.{m}.{p}" for d in ("depth", "mono_depth")
                    for m in ("adapter.D_fc1", "adapter.D_fc2", "deconv_adpt")
                    for p in ("weight", "bias")}
    if (changed or set(new) != stage2_names or not {
            "depth.deconv_adpt.bias", "mono_depth.deconv_adpt.bias"} <= set(nonzero)):
        raise AssertionError(f"stage-2 CLI: frozen changed {changed[:5]}, new "
                             f"{new}, non-zero {nonzero}")
    step_ms = [(e - s) * 1e3 for s, e, *_ in steps]
    print(f"stage-2 CLI B={EVAL_BATCH} {opt.width}x{opt.height} bf16: steps "
          f"{[round(t, 3) for t in step_ms]} ms; validations "
          f"{[round((e - s) * 1e3, 3) for s, e in vals]} ms; checkpoints "
          f"{folders}; whole run {wall:.2f} s; peak device memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB)")
    return os.path.join(log, "cs_final"), counts


def serve_stage2(folder):
    """Serving a stage-2 checkpoint (the stage-2 CLI's final one): a merged
    bf16 session on the card and an f32 session on the CPU, both built
    from the folder with their decoder adapters; one teacher and one
    student request of B=8 at 512x192 through the kernels, against the CPU
    f32 forward under DISP_*, with their launch counts."""
    import numpy as np

    from ppeadepth_tpu_torch.serve import InferenceSession

    opt = STAGE2_B
    t0 = time.perf_counter()
    sess = InferenceSession(opt, checkpoint=folder, device="cuda", dtype="bfloat16")
    cpu = InferenceSession(opt, checkpoint=folder, device="cpu", dtype="float32")
    print(f"stage-2 serve: sessions built from {folder} in "
          f"{time.perf_counter() - t0:.2f} s")
    img = np.random.RandomState(SEED + 7).rand(
        BATCH, opt.height, opt.width, 3).astype("float32")
    requests = [(img, np.roll(img, (2, 5), (1, 2)).copy())]
    return {"predict_depth_stage2": serve_teacher(sess, cpu, opt, requests,
                                                  "stage-2 teacher"),
            "predict_depth_multi_stage2": serve_student(sess, cpu, opt, requests,
                                                        "stage-2 student")}


def _occlude(rng, img):
    """A copy of the images `img` [B, H, W, 3] with three black rectangles
    of a quarter of the height and width each: the occlusion that DOMD
    leaves and the --dyn_cv in-fill reads (channel sum below 0.15)."""
    img = img.copy()
    B, H, W, _ = img.shape
    for b in range(B):
        for _ in range(3):
            y0, x0 = rng.randint(0, H - H // 4), rng.randint(0, W - W // 4)
            img[b, y0:y0 + H // 4, x0:x0 + W // 4] = 0
    return img


def serve_dyn(folder):
    """Serving under --dyn_cv (DYN_B: the stage-2 network with the
    DynamicDepth volume) from the stage-2 CLI's final checkpoint `folder`:
    a merged bf16 session on the card and an f32 session on the CPU; one
    student request of B=8 at 512x192 whose lookup frames carry black
    patches, against the CPU f32 forward under DISP_*, kernel C never
    launched and the dyn volume once."""
    import numpy as np

    from ppeadepth_tpu_torch.serve import InferenceSession

    opt = DYN_B
    sess = InferenceSession(opt, checkpoint=folder, device="cuda", dtype="bfloat16")
    cpu = InferenceSession(opt, checkpoint=folder, device="cpu", dtype="float32")
    rng = np.random.RandomState(SEED + 10)
    img = rng.rand(BATCH, opt.height, opt.width, 3).astype("float32")
    requests = [(img, _occlude(rng, np.roll(img, (2, 5), (1, 2))))]
    return {"predict_depth_multi_dyn": serve_student(sess, cpu, opt, requests,
                                                     "dyn student")}


def serve_drawn_adapters(sd2):
    """Serving the stage-2 weights `sd2`, whose decoder adapters are drawn
    non-zero (`_stage2_state_dict`), as a trained model's may be: merged
    bf16 sessions on the card, one B=8 request at 512x192 whose lookup
    frames carry black patches, through the kernels: the stage-2 teacher
    and student and the --dyn_cv student, each against the CPU f32
    forward, the mean held to BF16_PLAIN_MARGIN x that of the same bf16
    forward by the plain versions on the CPU (`_compare_disp`), with their
    launch counts; and the --dyn_cv student in f32 on the card against the
    CPU's, max |d disp| <= EVAL_CPU_REL_TOL."""
    import numpy as np

    from ppeadepth_tpu_torch.serve import InferenceSession

    rng = np.random.RandomState(SEED + 10)
    img = rng.rand(BATCH, STAGE2_B.height, STAGE2_B.width, 3).astype("float32")
    requests = [(img, _occlude(rng, np.roll(img, (2, 5), (1, 2))))]
    bins = dict(min_depth_bin=DEPTH_BINS[0], max_depth_bin=DEPTH_BINS[1])
    counts = {}
    for opt, key in ((STAGE2_B, "stage2_drawn"), (DYN_B, "dyn_drawn")):
        card, cpu, plain = (
            InferenceSession(opt, sd2, device=dev, dtype=dtype, **bins)
            for dev, dtype in (("cuda", "bfloat16"), ("cpu", "float32"),
                               ("cpu", "bfloat16")))
        tag = "dyn" if opt.dyn_cv else "stage-2"
        if not opt.dyn_cv:
            counts["predict_depth_" + key] = serve_teacher(
                card, cpu, opt, requests, f"{tag} teacher, drawn adapters", plain)
        counts["predict_depth_multi_" + key] = serve_student(
            card, cpu, opt, requests, f"{tag} student, drawn adapters", plain)
        del card, plain
    card = InferenceSession(DYN_B, sd2, device="cuda", dtype="float32", **bins)
    K, invK = _kitti_K(DYN_B.height // 4, DYN_B.width // 4, 1)
    img, lk = requests[0][0][:1], requests[0][1][:1]
    got, ref = (s.predict_depth_multi(img, lk, K, invK) for s in (card, cpu))
    lo, hi = 1.0 / DYN_B.max_depth, 1.0 / DYN_B.min_depth
    dd = np.abs((1.0 / got - 1.0 / ref) / (hi - lo))
    print(f"dyn student, drawn adapters, f32 on the card: |d disp| vs CPU f32 "
          f"mean {dd.mean():.3e} max {dd.max():.3e} (tol {EVAL_CPU_REL_TOL:g})")
    if not dd.max() <= EVAL_CPU_REL_TOL:
        raise AssertionError("dyn student f32: the card disagrees with the CPU")
    return counts


def serve_breadth(sd_b):
    """Merged bf16 serving with every breadth adapter (`BREADTH_B`,
    adpt_test 2, weights `sd_b` with every adapter drawn non-zero) on the
    card, one B=8 request: the teacher and the student, then the teacher
    under each other variant of `BREADTH_VARIANTS` (with the transition and
    input adapters too, on weights of their own from `_random_state_dict`);
    each with its launch counts (kernels A and B per
    block, C once for the student) and against the CPU f32 forward, the mean
    held to BF16_PLAIN_MARGIN x that of the same bf16 forward by the plain
    versions on the CPU (`_compare_disp`), as `serve_drawn_adapters` does:
    the drawn transition adapters put these weights where that rule, not
    DISP_MEAN_TOL, applies. Returns the counts by path."""
    import numpy as np

    from ppeadepth_tpu_torch.serve import InferenceSession

    rng = np.random.RandomState(SEED + 11)
    img = rng.rand(BATCH, BREADTH_B.height, BREADTH_B.width, 3).astype("float32")
    requests = [(img, np.roll(img, (2, 5), (1, 2)).copy())]
    bins = dict(min_depth_bin=DEPTH_BINS[0], max_depth_bin=DEPTH_BINS[1])
    counts = {}
    for v in (2,) + BREADTH_VARIANTS:
        opt = BREADTH_B.replace(adpt_test=v)
        sd = sd_b if v == 2 else _random_state_dict(opt)
        t0 = time.perf_counter()
        card, cpu, plain = (
            InferenceSession(opt, sd, device=dev, dtype=dtype, **bins)
            for dev, dtype in (("cuda", "bfloat16"), ("cpu", "float32"),
                               ("cpu", "bfloat16")))
        print(f"breadth adpt_test {v}: sessions built in "
              f"{time.perf_counter() - t0:.2f} s")
        counts[f"predict_depth_breadth_{v}"] = serve_teacher(
            card, cpu, opt, requests, f"breadth adpt_test {v} teacher", plain)
        if v == 2:
            counts["predict_depth_multi_breadth_2"] = serve_student(
                card, cpu, opt, requests, "breadth adpt_test 2 student", plain)
        del card, cpu, plain
    return counts


def eval_ori_r50():
    """The legacy eval's ResNet-50 teacher (`eval_depth_ori --eval_teacher
    --num_layers 50`, in-process) on the synthetic KITTI set in the current
    directory: seeded mono_encoder.pth (Bottleneck ResNet-50) and
    mono_depth.pth (the Monodepth2 decoder on its 64-2048 widths), BN
    statistics calibrated by one train-mode pass at half the resolution;
    no kernel launched (cuDNN convs), the card's f32 pass against the
    port's CPU pass on the first 2 images (EVAL_CPU_REL_TOL). Returns its
    counts."""
    import os

    import numpy as np
    import torch

    from ppeadepth_tpu_torch import eval_depth_ori as E
    from ppeadepth_tpu_torch import kernels
    from ppeadepth_tpu_torch.models.resnet import ResnetEncoder
    from ppeadepth_tpu_torch.models.resnet_matching import DepthDecoder
    from ppeadepth_tpu_torch.options import parse_args

    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED + 13)
    enc = ResnetEncoder(50)
    nets = {"mono_encoder": enc, "mono_depth": DepthDecoder(enc.num_ch_enc)}
    with torch.no_grad():
        for net in nets.values():
            for name, t in net.state_dict().items():
                if not torch.is_floating_point(t) or "running" in name:
                    continue
                scale, shift = ((0.05, 0.0) if name.endswith("bias") else
                                (0.1, 1.0) if t.dim() == 1 else
                                (t[0].numel() ** -0.5, 0.0))
                t.copy_(torch.from_numpy(
                    rng.randn(*t.shape).astype("float32") * scale + shift))
        bns = [m for net in nets.values() for m in net.modules()
               if isinstance(m, torch.nn.BatchNorm2d)]
        for m in bns:
            m.reset_running_stats()
            m.momentum = None  # one pass: running stats = batch stats
        img = torch.from_numpy(rng.rand(
            2, 3, SHIPPED_B.height // 2, SHIPPED_B.width // 2).astype("float32"))
        for net in nets.values():
            net.train()
        nets["mono_depth"](enc(img))
        for m in bns:
            m.momentum = 0.1
    os.makedirs("legacy50")
    for name, net in nets.items():
        torch.save(net.eval().state_dict(), os.path.join("legacy50", f"{name}.pth"))
    print(f"eval_ori_r50: legacy ResNet-50 teacher written in "
          f"{time.perf_counter() - t0:.2f} s")
    opt = parse_args(["--data_path", "kitti", "--eval_split", "smoke",
                      "--load_weights_folder", "legacy50", "--height", "192",
                      "--width", "640", "--batch_size", str(EVAL_BATCH),
                      "--num_workers", "8", "--eval_teacher", "--num_layers",
                      "50"])
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    d = E.predict_disps(opt, "splits", device="cuda")
    wall = time.perf_counter() - t0
    counts = dict(kernels.launch_counts)
    _check_counts(counts, {k: 0 for k in counts}, "eval_ori_r50")
    if d.shape != (N_TEST, opt.height, opt.width) or not np.isfinite(d).all():
        raise AssertionError(f"eval_ori_r50: disparities {d.shape}, finite "
                             f"{np.isfinite(d).all()}")
    cpu = E.predict_disps(opt.replace(eval_split="smoke2"), "splits",
                          device="cpu")
    err, peak = np.abs(d[:2] - cpu).max(), np.abs(cpu).max()
    errors = E.evaluate(opt, "splits", device="cuda")
    print(f"eval_ori_r50: {N_TEST} images in {wall:.2f} s "
          f"({wall / N_TEST * 1e3:.2f} ms an image, f32, B={EVAL_BATCH}); "
          f"scaled disparity range [{d.min():.4f}, {d.max():.4f}]; card vs CPU "
          f"on 2 images max|d|={err:.3e} max|ref|={peak:.3e} (tol "
          f"{EVAL_CPU_REL_TOL:g} x max|ref|); metrics {list(errors)}")
    if not (err <= EVAL_CPU_REL_TOL * peak and np.isfinite(errors).all()):
        raise AssertionError("eval_ori_r50: the card's pass disagrees with "
                             "the CPU's")
    return counts


def dp_world1():
    """Data parallelism at world size 1 on the card: the training CLI from
    the seed checkpoint in the current directory (`train_cli`'s), f32 (TF32
    off), DP_EPOCHS epoch of B=12, run twice in-process (`_run_cli`):
    without a process group, then under one over NCCL (torchrun's
    variables set in this process: PPEA_DISTRIBUTED=1, RANK 0, WORLD_SIZE
    1, a free port), where every BN is a GlobalBatchNorm and the step
    all-reduces its loss sums, gradients and metrics. The first step's
    metrics within PARITY_METRIC_TOL of the plain run's and every step's
    loss within DP_DRIFT_REL relative, each step's launches
    `_expected_launches`, the all-reduces and broadcasts counted
    (`parallel.dist.collective_counts`); the medians and peaks of both runs
    printed. Returns the process-group run's counts and the plain run's
    steps (`dp_world2` compares with them)."""
    import numpy as np
    import torch

    from ppeadepth_tpu_torch.parallel import dist

    opt = TRAIN_B.replace(compute_dtype="float32")
    expected = _expected_launches(opt)
    runs = {}
    for tag in ("plain", "dp"):
        env = {}
        if tag == "dp":
            env = dict(PPEA_DISTRIBUTED="1", RANK="0", WORLD_SIZE="1",
                       LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
                       MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()))
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        dist.collective_counts.clear()
        args = _dp_args(tag)
        steps, vals = [], []
        try:
            trainer, wall, counts = _run_cli(args, steps, vals)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        peak = torch.cuda.max_memory_allocated()
        collectives = dict(dist.collective_counts)
        if dist.enabled():
            raise AssertionError("dp_world1: the process group outlived the CLI")
        for i, (_, _, launched, _, _) in enumerate(steps):
            if launched != expected:
                raise AssertionError(f"dp_world1 {tag} step {i}: launches "
                                     f"{launched}, expected {expected}")
        n_bn = sum(isinstance(m, dist.GlobalBatchNorm)
                   for m in trainer.model.modules())
        ms = [(e - s) * 1e3 for s, e, *_ in steps]
        med = float(np.median(ms[1:]))
        print(f"dp_world1 {tag}: {len(steps)} f32 steps B={EVAL_BATCH} "
              f"640x192 in a {wall:.2f} s run; steps {[round(t, 3) for t in ms]} "
              f"ms, median after the first {med:.3f} ms; peak device memory "
              f"{peak} bytes ({peak / 2**30:.3f} GiB); GlobalBatchNorm modules "
              f"{n_bn}; collectives {collectives}; losses "
              f"{[round(m['loss'], 6) for *_, m, _ in steps]}")
        runs[tag] = (steps, collectives, n_bn, counts)
        del trainer
    (s_plain, c_plain, n_plain, _), (s_dp, c_dp, n_dp, counts) = (
        runs["plain"], runs["dp"])
    first, later = _dp_drift("dp_world1", s_plain, [m for *_, m, _ in s_dp])
    if not (first <= PARITY_METRIC_TOL and later <= DP_DRIFT_REL
            and c_plain == {} and n_plain == 0
            and n_dp > 0 and c_dp.get("all_reduce", 0) > 0
            and c_dp.get("broadcast", 0) > 0):
        raise AssertionError("dp_world1: the process-group run disagrees with "
                             "the plain run, or its collectives did not run")
    return counts, s_plain


def _free_port():
    import socket

    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def _dp_args(name):
    """The CLI flags of the data-parallel runs: f32, DP_EPOCHS epoch of the
    global B=12 from the seed checkpoint, no validation."""
    return _cli_args(["--compute_dtype", "float32", "--weights_init",
                      "scratch", "--num_epochs", str(DP_EPOCHS),
                      "--validate_every", "0", "--log_dir", "dp_ckpt",
                      "--name", name, "--pytorch_random_seed", "0",
                      "--load_weights_folder", "seed"])


def _dp_drift(tag, plain, metrics):
    """(max |d metric| at the first step, the loss's largest relative
    difference over the steps) of a data-parallel run's per-step
    `metrics` against the plain run's steps, printed."""
    if len(metrics) != len(plain) or not plain:
        raise AssertionError(f"{tag}: {len(metrics)} steps, the plain run "
                             f"{len(plain)}")
    # the first step starts from the same weights; after it, entries whose
    # gradient is near zero have moved lr of either sign in the two runs
    # (tests/test_torch_train_step.py's four-step check: 5e-3 relative)
    first = max(abs(plain[0][3][k] - metrics[0][k]) for k in plain[0][3])
    later = max(abs(m["loss"] / a[3]["loss"] - 1) for a, m in zip(plain, metrics))
    print(f"{tag}: against the run without a process group, max |d metric| "
          f"at the first step {first:.3e} (tol {PARITY_METRIC_TOL:g}), the "
          f"loss's largest relative difference over {len(metrics)} steps "
          f"{later:.3e} (tol {DP_DRIFT_REL:g})")
    return first, later


def dp_rank(out, args):
    """One rank of `dp_world2`, in its own process: the training CLI with
    `args` (`_run_cli`; the process group from torchrun's variables in the
    environment), TF32 off as in the parent run; writes to `out` (JSON)
    this rank's card, each step's milliseconds, launches and metrics, the
    run's counts and collectives, its GlobalBatchNorm modules, peak device
    memory and the checkpoint folders it wrote (None where it wrote
    none)."""
    import torch

    from ppeadepth_tpu_torch.parallel import dist
    from ppeadepth_tpu_torch.train import trainer as trainer_mod

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    save_model, saved = trainer_mod.Trainer.save_model, []

    def recorded_save(self, suffix):
        folder = save_model(self, suffix)
        saved.append(folder)
        return folder

    trainer_mod.Trainer.save_model = recorded_save
    steps = []
    trainer, wall, counts = _run_cli(args, steps, [])
    rec = dict(rank=int(os.environ["RANK"]), card=torch.cuda.current_device(),
               steps=[dict(ms=(e - s) * 1e3, launched=c, metrics=m)
                      for s, e, c, m, _ in steps],
               counts=counts, collectives=dict(dist.collective_counts),
               n_bn=sum(isinstance(m, dist.GlobalBatchNorm)
                        for m in trainer.model.modules()),
               peak=torch.cuda.max_memory_allocated(), wall=wall, saved=saved,
               metrics_file=trainer._metrics_file is not None)
    with open(out, "w") as fh:
        json.dump(rec, fh)


def dp_world2(plain):
    """Data parallelism at world size 2 on one card: DP_WORLD OS processes
    (`python3 chip_smoke.py --dp_rank`, as tests/torch_dist_worker.py runs
    ranks on the CPU), ranks 0 and 1 of a gloo group
    (PPEA_DIST_BACKEND=gloo: NCCL refuses two ranks on one card), each
    taking card LOCAL_RANK % device_count(), card 0 here, and running
    `dp_world1`'s CLI (`_dp_args`) on its B=6 of the global B=12. Holds
    the first step's metrics within PARITY_METRIC_TOL of `plain`
    (`dp_world1`'s run without a group) and every step's loss within
    DP_DRIFT_REL; each rank's launches a step to `_expected_launches`;
    all-reduces and broadcasts counted and every BN a GlobalBatchNorm on
    both ranks; checkpoints and metrics.jsonl from rank 0 only. A rank
    that fails or outlasts DP_RANK_TIMEOUT fails the run. Prints each
    rank's median step and peak memory: two processes on one card check
    correctness on CUDA tensors across ranks, not multi-card speed.
    Returns the launch counts of both ranks summed."""
    import gc

    import numpy as np
    import torch

    opt = TRAIN_B.replace(compute_dtype="float32")
    expected = _expected_launches(opt)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"dp_world2: this process holds {torch.cuda.memory_reserved()} "
          f"bytes of the card while its {DP_WORLD} ranks run")
    env = dict(os.environ, PPEA_DISTRIBUTED="1", PPEA_DIST_BACKEND="gloo",
               WORLD_SIZE=str(DP_WORLD), LOCAL_WORLD_SIZE=str(DP_WORLD),
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()))
    args = _dp_args("world2")
    outs = [os.path.abspath(f"dp_rank{r}.json") for r in range(DP_WORLD)]
    logs = [open(f"dp_rank{r}.log", "w") for r in range(DP_WORLD)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp_rank", outs[r], *args],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(DP_WORLD)]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, DP_RANK_TIMEOUT - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fh in logs:
            fh.close()
    wall = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(f"dp_rank{r}.log") as fh:
                tail = fh.read()[-3000:]
            raise AssertionError(f"dp_world2: rank {r} exited with "
                                 f"{p.returncode} after {wall:.2f} s "
                                 f"(limit {DP_RANK_TIMEOUT} s):\n{tail}")
    ranks = []
    for out in outs:
        with open(out) as fh:
            ranks.append(json.load(fh))
    n_cards = torch.cuda.device_count()
    for r, rec in enumerate(ranks):
        ms = [s["ms"] for s in rec["steps"]]
        print(f"dp_world2 rank {r} on card {rec['card']}: {len(ms)} f32 steps "
              f"of B={EVAL_BATCH // DP_WORLD} (global {EVAL_BATCH}) 640x192 in "
              f"a {rec['wall']:.2f} s CLI run; steps {[round(t, 3) for t in ms]} "
              f"ms, median after the first {float(np.median(ms[1:])):.3f} ms; "
              f"peak device memory {rec['peak']} bytes "
              f"({rec['peak'] / 2**30:.3f} GiB); GlobalBatchNorm modules "
              f"{rec['n_bn']}; collectives {rec['collectives']}; checkpoints "
              f"written {rec['saved']}; losses "
              f"{[round(s['metrics']['loss'], 6) for s in rec['steps']]} "
              f"(two processes sharing one card: a correctness check on CUDA "
              f"tensors, not multi-card speed)")
        for i, s in enumerate(rec["steps"]):
            if s["launched"] != expected:
                raise AssertionError(f"dp_world2 rank {r} step {i}: launches "
                                     f"{s['launched']}, expected {expected}")
        main = r == 0  # writes every checkpoint and metrics.jsonl, alone
        if not (rec["rank"] == r and rec["card"] == r % n_cards
                and rec["n_bn"] > 0
                and rec["collectives"].get("all_reduce", 0) > 0
                and rec["collectives"].get("broadcast", 0) > 0
                and rec["saved"] and rec["metrics_file"] == main
                and all((f is not None) == main for f in rec["saved"])):
            raise AssertionError(f"dp_world2: rank {r} ran on card "
                                 f"{rec['card']} with {rec['n_bn']} global BNs, "
                                 f"collectives {rec['collectives']}, checkpoints "
                                 f"{rec['saved']}, metrics.jsonl "
                                 f"{rec['metrics_file']}")
    # every rank reports the same metrics (averaged over the ranks)
    for a, b in zip(ranks[0]["steps"], ranks[1]["steps"]):
        if a["metrics"] != b["metrics"]:
            raise AssertionError(f"dp_world2: the ranks' metrics differ: "
                                 f"{a['metrics']} against {b['metrics']}")
    first, later = _dp_drift("dp_world2", plain,
                             [s["metrics"] for s in ranks[0]["steps"]])
    print(f"dp_world2: {DP_WORLD} ranks done in {wall:.2f} s")
    if not (first <= PARITY_METRIC_TOL and later <= DP_DRIFT_REL):
        raise AssertionError("dp_world2: the two-rank run disagrees with the "
                             "plain run")
    return {k: sum(rec["counts"][k] for rec in ranks) for k in ranks[0]["counts"]}


def check_dyn_volume(dev, rng, opt=DYN_B):
    """The DynamicDepth volume (`--dyn_cv`; plain torch, as JAX keeps it on
    lax, so no kernel) at the stage-2 step's shapes: B=TRAIN_BATCH, C=128,
    48x128, 96 bins, the pool in-fill from 192x512 lookup images with black
    patches, the last item matching-augmented (in-fill gated off). On the
    card against the same function on the CPU (first 2 items) off the
    edge-mask boundaries (DYN_REL_TOL); the in-fill changed the gated-on
    items and not the gated-off one; its time per call (CUDA events) and
    the peak memory of one call beyond its inputs, one item at a time as
    shipped and CHUNK_ITEMS items at a time (the volumes within
    DYN_REL_TOL), beside its bound."""
    import torch

    from ppeadepth_tpu_torch.ops import cost_volume as CV

    B = TRAIN_BATCH
    C, H, W, _, _ = _stage_shapes(opt)[0]
    D = opt.num_depth_bins
    K, invK = (torch.from_numpy(a).to(dev) for a in _kitti_K(H, W, B))
    T = torch.from_numpy(_pose_4x4(rng, B)).to(dev)
    bins = CV.compute_depth_bins(*DEPTH_BINS, D, device=dev)
    _, _, _, near, samples = _edge_geometry(K, invK, T, bins, H, W)
    T = T[:, None]
    cur = _sweep_feats(dev, rng, B, C, H, W, torch.float32)
    lk = _sweep_feats(dev, rng, B, C, H, W, torch.float32)[:, None]
    images = torch.from_numpy(_occlude(rng, rng.rand(
        B, opt.height, opt.width, 3).astype("float32"))).to(dev).permute(
            0, 3, 1, 2)[:, None]
    aug = torch.zeros(B, 1, 1, 1, device=dev)
    aug[-1] = 1

    def run(n=B, device=dev, **kw):
        args = (cur, lk, T, K, invK, bins, images, aug)
        kw = dict(dict(cv_min=opt.cv_min, set_1=opt.cv_set_1, pool=opt.cv_pool,
                       pool_r=opt.cv_pool_radius, pool_th=opt.cv_pool_th), **kw)
        with torch.no_grad():
            return CV.plane_sweep_cost_volume_dyn(
                *(a[:n].to(device) if a.dim() > 1 else a.to(device)
                  for a in args), **kw)

    def peak_of(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    (cost, missing), peak = peak_of(run)
    plain, _ = run(pool=False, set_1=False)
    filled = [(cost[b] != plain[b]).any().item() for b in range(B)]
    ref, ref_missing = run(2, "cpu")
    # a pixel with a sample near an edge-mask boundary in any bin
    near = near[:2].any(1, keepdim=True).expand(-1, D, -1, -1).cpu()
    diff = (cost[:2].cpu() - ref).abs()
    peak_ref = ref.abs().max().item()
    err = diff[~near].max().item()
    print(f"dyn volume [{B},{H},{W},{C}] D={D} f32, pool r={opt.cv_pool_radius}: "
          f"card vs CPU (2 items) max|d| off the mask boundaries {err:.3e} "
          f"of max|ref| {peak_ref:.3e} (tol {DYN_REL_TOL:g} x max|ref|; "
          f"{near.float().mean().item():.2e} of the entries left out); missing "
          f"share {ref_missing.mean().item():.4f}; in-fill changed items "
          f"{[b for b in range(B) if filled[b]]} (item {B - 1} augmented)")
    if not (err <= DYN_REL_TOL * peak_ref and torch.equal(
            missing[:2].cpu()[~near], ref_missing[~near])):
        raise AssertionError("dyn volume: the card disagrees with the CPU")
    if filled[-1] or not all(filled[:-1]):
        raise AssertionError(f"dyn volume: the in-fill changed items {filled}")
    # the same volume in chunks of CHUNK_ITEMS items, beside the shipped one
    # item at a time (JAX's lax.map)
    try:
        CV._DYN_ITEMS = CHUNK_ITEMS
        (chunked, _), peak_chunked = peak_of(run)
        chunk_err = (chunked - cost).abs().max().item()
        if not chunk_err <= DYN_REL_TOL * peak_ref:
            raise AssertionError(f"dyn volume: {CHUNK_ITEMS} items a chunk "
                                 f"differ by {chunk_err:.3e}")
        (ms_chunked,) = _time_turns([run], 3)
    finally:
        CV._DYN_ITEMS = 1
    (ms,) = _time_turns([run], 3)
    # the bound: kernel C's work (`_sweep_bound`), the mask's warp (~12
    # operations an (item, bin, pixel)) and, per entry the in-fill changed,
    # 26 comparisons a channel; the features and images read once, the
    # volume and the missing mask written once
    infilled = (cost != plain).sum().item()
    flop = 12 * C * samples + 24 * B * D * H * W + 26 * C * infilled
    nbytes = 2 * B * H * W * C * 4 + images.numel() * 4 + 8 * B * D * H * W
    bound, by = _bound_ms(nbytes, flop, F32_FLOP_PER_S)
    print(f"dyn volume: {ms:.3f} ms per call (CUDA events, B={B}, one item a "
          f"chunk), bound {bound:.4f} ms ({by}; {flop / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB, {infilled} in-filled entries), peak device "
          f"memory beyond its inputs {peak} bytes ({peak / 2**30:.3f} GiB); "
          f"{CHUNK_ITEMS} items a chunk {ms_chunked:.3f} ms, {peak_chunked} "
          f"bytes ({peak_chunked / 2**30:.3f} GiB), max|d| {chunk_err:.3e}; "
          f"{samples} observed samples")
    return dict(ms=ms, bound_ms=bound, bound_by=by, peak_bytes=peak,
                ms_chunked=ms_chunked, peak_bytes_chunked=peak_chunked,
                max_abs_err=err)


def _rel(a, b):
    import numpy as np

    return float(np.abs(a - b).max() / np.abs(b).max())


def eval_cli(folder, profile, kind="kitti"):
    """`python -m ppeadepth_tpu_torch.train --eval --lk_backend pallas` on
    the final checkpoint, f32, with --eval_teacher and --post_process, then
    the same under --lk_backend lax; the launches of each run (read with
    the counts set to 0 just before it) are exact, their metrics finite,
    and the pallas run's disparities agree with the lax run's and, on the
    first two test images, with the port's CPU eval. `kind`: "kitti", the
    synthetic KITTI set; "cityscapes", `--train_cs --dc --eval`
    (--eval_split cityscapes) on the cityscapes_eval layout; "ddad",
    `python -m ppeadepth_tpu_torch.evaluate_ddad` on the synthetic DDAD set
    at the forced 320x480 with its 200 m clamp. With `profile`, a
    device-time breakdown of the pallas eval step on the first batch."""
    import numpy as np
    import torch

    from ppeadepth_tpu_torch import data as D
    from ppeadepth_tpu_torch import evaluate_ddad, kernels
    from ppeadepth_tpu_torch.ckpt import io as ckpt_io
    from ppeadepth_tpu_torch.eval import evaluator
    from ppeadepth_tpu_torch.models import RepDepth
    from ppeadepth_tpu_torch.options import parse_args
    from ppeadepth_tpu_torch.train import __main__ as cli
    from ppeadepth_tpu_torch.train.trainer import readlines

    extra = ["--load_weights_folder", folder, "--eval_teacher", "--post_process"]
    entry, module, make_opt = cli.main, "train --eval", parse_args
    if kind == "cityscapes":
        base, size, n_test, tag = (_cs_cli_args(["--eval", *extra]), STAGE2_B,
                                   N_CS_TEST, "eval CLI cityscapes")
        ds_name, data_path = "cityscapes_eval", "cs_eval"
        index = "splits/cityscapes_preprocessed/test_files.txt"
    elif kind == "ddad":
        base, size, n_test, tag = _ddad_args(extra), DDAD_B, N_DDAD, "eval DDAD"
        ds_name, data_path, index = "ddad", "ddad", "ddad/val_index.txt"
        entry, module = evaluate_ddad.main, "evaluate_ddad"

        def make_opt(args):
            return evaluate_ddad.eval_config(parse_args(args))
    else:
        base, size, n_test, tag = (_cli_args(["--eval", *extra]), SHIPPED_B,
                                   N_TEST, "eval CLI")
        ds_name, data_path, index = "kitti", "kitti", "splits/smoke/test_files.txt"
    batches = -(-n_test // EVAL_BATCH)
    captured, runs = [], {}
    predict = evaluator.predict_disps

    def capture(*a, **kw):
        t0 = time.perf_counter()
        out = predict(*a, **kw)
        captured.append((*out, time.perf_counter() - t0))
        return out

    evaluator.predict_disps = capture
    try:
        for backend in ("pallas", "lax"):
            args = base + ["--lk_backend", backend]
            print(f"{tag}: python -m ppeadepth_tpu_torch.{module} {' '.join(args)}")
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            errors, mono = entry(args)
            wall = time.perf_counter() - t0
            counts = dict(kernels.launch_counts)
            calls = _eval_lk_calls(size)[(backend == "lax"):]
            _check_counts(counts, {"lk_dwconv": batches * sum(c[4] for c in calls),
                                   "plane_sweep": 2 * batches, "ffn_fused": 0,
                                   "lk_dwconv_dx": 0, "warp_fwd": 0, "warp_bwd": 0},
                          f"{tag} {backend}: {n_test} images in {batches} batches")
            if not (np.isfinite(errors).all() and np.isfinite(mono).all()):
                raise AssertionError(f"{tag} {backend}: non-finite metrics")
            device_pass = captured[-1][2]
            print(f"{tag} {backend}: {wall:.2f} s for {n_test} images "
                  f"({wall / n_test * 1e3:.2f} ms per image, model load, "
                  f"loader and CPU metric pass included); the device pass with "
                  f"its loader {device_pass:.3f} s ({device_pass / n_test * 1e3:.2f} "
                  f"ms per image); student {errors.tolist()}, teacher {mono.tolist()}")
            runs[backend] = (errors, mono, *captured[-1][:2], counts)
    finally:
        evaluator.predict_disps = predict

    (e_p, m_p, d_p, md_p, counts), (e_l, m_l, d_l, md_l, _) = runs["pallas"], runs["lax"]
    disp_err = max(_rel(d_p, d_l), _rel(md_p, md_l))
    metric_err = max(float(np.max(np.abs(a - b) / np.abs(b)))
                     for a, b in ((e_p, e_l), (m_p, m_l)))
    print(f"{tag} pallas vs lax: disparities max|d| {disp_err:.3e} of max|ref| "
          f"(tol {EVAL_LAX_REL_TOL:g}), metrics max rel {metric_err:.3e} "
          f"(tol {EVAL_METRIC_REL_TOL:g})")
    if not (disp_err <= EVAL_LAX_REL_TOL and metric_err <= EVAL_METRIC_REL_TOL):
        raise AssertionError(f"{tag}: pallas and lax disagree")

    opt = make_opt(base + ["--lk_backend", "pallas"]).with_mode_presets()
    if (opt.height, opt.width) != (size.height, size.width):
        raise AssertionError(f"{tag}: evaluated at {opt.width}x{opt.height}")
    model = RepDepth(opt)
    track = ckpt_io.load_model(folder, model)
    files = readlines(index)
    if profile:
        ds = D.DATASETS[ds_name](data_path, files[:EVAL_BATCH], opt.height,
                                 opt.width, [0, -1], 4)
        batch = next(iter(D.DataLoader(ds, EVAL_BATCH, shuffle=False)))
        batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
        step = evaluator.make_eval_step(model.cuda().eval(), opt, True)
        bins = (track["min_depth_bin"], track["max_depth_bin"])
        profile_serving(f"eval_step f32 B={EVAL_BATCH} pallas",
                        lambda: step(batch, *bins), [()])
        model.cpu()

    # the port's CPU eval of the first two test images, same checkpoint
    files = files[:2]
    ds = D.DATASETS[ds_name](data_path, files, opt.height, opt.width, [0, -1], 4)
    t0 = time.perf_counter()
    with torch.no_grad():
        d_c, md_c = evaluator.predict_disps(
            model, opt, iter(D.DataLoader(ds, 2, shuffle=False, num_workers=2,
                                          drop_last=False)),
            track["min_depth_bin"], track["max_depth_bin"], True, device="cpu")
    cpu_err = max(_rel(d_p[:2], d_c), _rel(md_p[:2], md_c))
    print(f"{tag} card vs CPU (first 2 test images, f32, CPU pass "
          f"{time.perf_counter() - t0:.2f} s): disparities max|d| {cpu_err:.3e} "
          f"of max|ref| (tol {EVAL_CPU_REL_TOL:g}); range [{d_c.min():.4f}, "
          f"{d_c.max():.4f}]")
    if not cpu_err <= EVAL_CPU_REL_TOL:
        raise AssertionError(f"{tag}: the card's disparities disagree with the CPU's")
    return counts


def ablation_cli(folder):
    """The per-block adapter ablation (`python -m
    ppeadepth_tpu_torch.evaluate_depth_layer`, through its
    `make_eval_fn` and `eval.ablation.run_block_ablation`) of the KITTI
    run's final checkpoint on the synthetic KITTI set, f32, for the first
    ABLATED adapter blocks of each encoder: the eval of the unablated
    weights reproduces `--eval` of the same checkpoint (EVAL_METRIC_REL_TOL
    per metric); gating a student (`encoder`) block changes the student's
    metrics, a teacher (`mono_encoder`) one leaves them as they were (the
    eval scores the student); repl.txt holds one line per block; the
    launches are those of the student's eval forward per batch and eval.
    Returns the run's counts."""
    import numpy as np

    from ppeadepth_tpu_torch import evaluate_depth_layer, kernels
    from ppeadepth_tpu_torch.eval import ablation
    from ppeadepth_tpu_torch.options import parse_args
    from ppeadepth_tpu_torch.train import __main__ as cli

    args = _cli_args(["--load_weights_folder", folder])
    print("ablation: python -m ppeadepth_tpu_torch.evaluate_depth_layer "
          + " ".join(args) + f" (the first {ABLATED} blocks of each encoder)")
    eval_cli_errors, _ = cli.main(["--eval", *args])
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    eval_fn, sd = evaluate_depth_layer.make_eval_fn(parse_args(args))
    every = {sub: ablation.adapter_block_paths(sd, sub)
             for sub in ("encoder", "mono_encoder")}
    blocks = [b for sub in every.values() for b in sub[:ABLATED]]
    # the ablation of `blocks` alone: their state_dict without the other
    # blocks' adapters, which the eval takes back from `sd`
    skipped = tuple(b + "." for sub in every.values() for b in sub[ABLATED:])
    subset = {k: v for k, v in sd.items() if not k.startswith(skipped)}
    base = eval_fn(sd)
    results = ablation.run_block_ablation(lambda part: eval_fn({**sd, **part}),
                                          subset, out_path="repl.txt")
    wall = time.perf_counter() - t0
    counts = dict(kernels.launch_counts)
    with open("repl.txt") as fh:
        lines = fh.read().splitlines()
    base_err = float(np.max(np.abs(base - eval_cli_errors)
                            / np.abs(eval_cli_errors)))
    print(f"ablation: unablated eval {base.tolist()}, --eval "
          f"{eval_cli_errors.tolist()}: max rel {base_err:.3e} (tol "
          f"{EVAL_METRIC_REL_TOL:g}); repl.txt {lines}; {1 + len(blocks)} "
          f"evals in {wall:.2f} s")
    if not base_err <= EVAL_METRIC_REL_TOL:
        raise AssertionError("ablation: the unablated eval is not --eval's")
    if [ln.split()[0] for ln in lines] != blocks:
        raise AssertionError(f"ablation: repl.txt names {lines}, not {blocks}")
    for block, errors in results:
        moved = not np.array_equal(errors, base)
        if moved != block.startswith("encoder.") or not np.isfinite(errors).all():
            raise AssertionError(f"ablation: {block} gives {errors.tolist()}, "
                                 f"unablated {base.tolist()}")
    n_batches = (1 + len(blocks)) * -(-N_TEST // EVAL_BATCH)
    per_batch = sum(c[4] for c in _eval_lk_calls(SHIPPED_B, False, False)[1:])
    _check_counts(counts, {"lk_dwconv": n_batches * per_batch,
                           "plane_sweep": n_batches, "ffn_fused": 0,
                           "lk_dwconv_dx": 0, "warp_fwd": 0, "warp_bwd": 0},
                  f"ablation: {1 + len(blocks)} evals of {N_TEST} images")
    return counts


LEGACY_BINS = (0.1, 20.0)  # the bin range the reference writes in encoder.pth


def _legacy_checkpoint(folder, rng):
    """Seeded legacy ManyDepth networks (`models.resnet_matching` and the
    ResNet-18 pose and mono nets) written in the reference's separate-file
    format to `folder`: encoder.pth (the bin range, height and width beside
    the weights), depth.pth, pose_encoder.pth, pose.pth, mono_encoder.pth
    and mono_depth.pth. Conv weights N(0, 1/fan_in), BN scales 1 + 0.1 N,
    biases 0.05 N; BN statistics calibrated by one train-mode pass of
    random images at half the resolution, as `_random_state_dict` does."""
    import os

    import torch

    from ppeadepth_tpu_torch.models.pose import PoseDecoder
    from ppeadepth_tpu_torch.models.resnet import ResnetEncoder
    from ppeadepth_tpu_torch.models.resnet_matching import (
        DepthDecoder, ResnetEncoderMatching)

    opt = SHIPPED_B
    enc = ResnetEncoderMatching(18, opt.num_depth_bins, opt.depth_binning)
    pose_enc, mono_enc = ResnetEncoder(18, 2), ResnetEncoder(18)
    nets = {"encoder": enc, "depth": DepthDecoder(), "pose_encoder": pose_enc,
            "pose": PoseDecoder(pose_enc.num_ch_enc, 2),
            "mono_encoder": mono_enc, "mono_depth": DepthDecoder()}

    def draw(t, scale, shift=0.0):
        t.copy_(torch.from_numpy(rng.randn(*t.shape).astype("float32")
                                 * scale + shift))

    with torch.no_grad():
        bns = []
        for net in nets.values():
            bns += [m for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d)]
            for name, t in net.state_dict().items():
                if not torch.is_floating_point(t) or "running" in name:
                    continue
                if name.endswith("bias"):
                    draw(t, 0.05)
                elif t.dim() == 1:
                    draw(t, 0.1, 1.0)
                else:
                    draw(t, t[0].numel() ** -0.5)
        for m in bns:
            m.reset_running_stats()
            m.momentum = None  # one pass: running stats = batch stats
        h, w = opt.height // 2, opt.width // 2
        img = torch.from_numpy(rng.rand(2, 3, h, w).astype("float32"))
        lk = torch.roll(img, (2, 5), (2, 3))
        K, invK = (torch.from_numpy(a) for a in _kitti_K(h // 4, w // 4, 2))
        for net in nets.values():
            net.train()
        feats, _, _ = enc(img, lk[:, None],
                          torch.from_numpy(_pose_4x4(rng, 2))[:, None], K, invK,
                          *LEGACY_BINS)
        nets["depth"](feats)
        nets["pose"](pose_enc(torch.cat([lk, img], 1)))
        nets["mono_depth"](mono_enc(img))
        for m in bns:
            m.momentum = 0.1
    os.makedirs(folder)
    for name, net in nets.items():
        sd = dict(net.eval().state_dict())
        if name == "encoder":
            sd.update(min_depth_bin=torch.tensor(LEGACY_BINS[0]),
                      max_depth_bin=torch.tensor(LEGACY_BINS[1]),
                      height=opt.height, width=opt.width)
        torch.save(sd, os.path.join(folder, f"{name}.pth"))


def eval_ori_cli():
    """The legacy ManyDepth eval (`ppeadepth_tpu_torch.eval_depth_ori`,
    in-process) on the synthetic KITTI set in the current directory, from
    seeded legacy-format checkpoints: the student, --eval_teacher,
    --zero_cost_volume and --static_camera, each with its launches (kernel
    C once a batch on the student's f32 [12, 64, 48, 160] features, no other
    kernel) and against the port's CPU pass on the first 2 images
    (EVAL_CPU_REL_TOL); then --save_pred_disps and --ext_disp_to_eval give
    the same metrics, and --eval_split benchmark writes N_TEST uint16 PNGs.
    Returns the student run's counts."""
    import os

    import numpy as np
    from PIL import Image

    from ppeadepth_tpu_torch import eval_depth_ori as E
    from ppeadepth_tpu_torch import kernels
    from ppeadepth_tpu_torch.options import parse_args

    t0 = time.perf_counter()
    _legacy_checkpoint("legacy", np.random.RandomState(SEED + 10))
    os.makedirs(os.path.join("splits", "smoke2"))
    with open(os.path.join("splits", "smoke", "test_files.txt")) as fh:
        first = fh.read().splitlines()[:2]
    with open(os.path.join("splits", "smoke2", "test_files.txt"), "w") as fh:
        fh.write("\n".join(first) + "\n")
    print(f"eval_ori: legacy checkpoint written in {time.perf_counter() - t0:.2f} s")
    opt = parse_args(["--data_path", "kitti", "--eval_split", "smoke",
                      "--load_weights_folder", "legacy", "--height", "192",
                      "--width", "640", "--batch_size", str(EVAL_BATCH),
                      "--num_workers", "8"])
    n_batches = -(-N_TEST // EVAL_BATCH)
    modes = {"student": {}, "--eval_teacher": dict(eval_teacher=True),
             "--zero_cost_volume": dict(zero_cost_volume=True),
             "--static_camera": dict(static_camera=True)}
    disps, counts = {}, {}
    for mode, flags in modes.items():
        o = opt.replace(**flags)
        tag = f"eval_ori {mode}"
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        d = E.predict_disps(o, "splits", device="cuda")
        wall = time.perf_counter() - t0
        counts[mode] = dict(kernels.launch_counts)
        _check_counts(counts[mode], {
            "plane_sweep": 0 if o.eval_teacher else n_batches, "lk_dwconv": 0,
            "lk_dwconv_dx": 0, "ffn_fused": 0, "warp_fwd": 0, "warp_bwd": 0}, tag)
        if d.shape != (N_TEST, opt.height, opt.width) or not np.isfinite(d).all():
            raise AssertionError(f"{tag}: disparities {d.shape}, finite "
                                 f"{np.isfinite(d).all()}")
        cpu = E.predict_disps(o.replace(eval_split="smoke2"), "splits",
                              device="cpu")
        err, peak = np.abs(d[:2] - cpu).max(), np.abs(cpu).max()
        print(f"{tag}: {N_TEST} images in {wall:.2f} s ({wall / N_TEST * 1e3:.2f} "
              f"ms an image, f32, B={EVAL_BATCH}); scaled disparity range "
              f"[{d.min():.4f}, {d.max():.4f}]; card vs CPU on 2 images "
              f"max|d|={err:.3e} max|ref|={peak:.3e} (tol {EVAL_CPU_REL_TOL:g} "
              f"x max|ref|)")
        if not err <= EVAL_CPU_REL_TOL * peak:
            raise AssertionError(f"{tag}: the card's pass disagrees with the CPU's")
        disps[mode] = d
    names = list(disps)
    for i, a in enumerate(names):
        for b in names[:i]:
            if not np.abs(disps[a] - disps[b]).max() > 1e-3:
                raise AssertionError(f"eval_ori: {a} and {b} give one answer")

    errors = E.evaluate(opt.replace(save_pred_disps=True), "splits", device="cuda")
    saved = os.path.join("legacy", "multi_smoke_split.npy")
    ext = E.evaluate(opt.replace(ext_disp_to_eval=saved), "splits", device="cuda")
    print(f"eval_ori: --save_pred_disps metrics {list(errors)}; "
          f"--ext_disp_to_eval of {saved} {list(ext)}")
    if not (np.isfinite(errors).all() and np.array_equal(errors, ext)):
        raise AssertionError("eval_ori: --ext_disp_to_eval scores differently")
    if E.evaluate(opt.replace(ext_disp_to_eval=saved, eval_split="benchmark"),
                  "splits", device="cuda") is not None:
        raise AssertionError("eval_ori: the benchmark split returned metrics")
    out = os.path.join("legacy", "benchmark_predictions")
    pngs = sorted(os.listdir(out))
    arrs = [np.asarray(Image.open(os.path.join(out, n))) for n in pngs]
    if len(pngs) != N_TEST or any(a.dtype != np.uint16 or a.shape != (352, 1216)
                                  or not 0 < a.max() <= 80 * 256 for a in arrs):
        raise AssertionError(f"eval_ori: benchmark PNGs {pngs[:3]} ...")
    print(f"eval_ori: --eval_split benchmark wrote {len(pngs)} uint16 PNGs of "
          f"1216x352, depth x256 in [{min(a.min() for a in arrs)}, "
          f"{max(a.max() for a in arrs)}]")
    return counts["student"]


AUG_TOL = 1e-5  # colours in [0, 1], card against CPU (f32, another order)


def check_fast_pipeline(dev):
    """--fast_pipeline's pieces: `augment_batch` on the card against the
    CPU on the same frames and factors at B=12, 640x192, every scale, a
    blank frame included, and `prepare_batch`'s wall at that size (3 frames
    of u8); then the native loader built from the port's csrc/loader.cc
    into build/native/ against the vendored libjpeg-turbo headers and
    Pillow's libjpeg (its command, build time and the libjpeg it needs)
    and its decode against PIL within tests/test_native_loader.py's bounds
    (equal at the native size, resized within 12 of PIL's bilinear on
    average, a missing file blank). A failed build fails the run:
    --fast_pipeline has no fallback."""
    import os

    import numpy as np
    import torch
    from PIL import Image

    from ppeadepth_tpu_torch.data import augment, native_loader as NL
    from ppeadepth_tpu_torch.data.fast_pipeline import prepare_batch

    rng = np.random.RandomState(SEED + 11)
    H, W, B = SHIPPED_B.height, SHIPPED_B.width, TRAIN_BATCH
    frames = {f: rng.rand(B, H, W, 3).astype("float32") for f in (0, -1, 1)}
    frames[-1][3] = 0.0
    K = np.tile(np.array([[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0], [0, 0, 1, 0],
                          [0, 0, 0, 1]], "float32"), (B, 1, 1))
    fac = augment.sample_jitter_factors(torch.Generator().manual_seed(SEED), B)
    ref = augment.augment_batch({f: torch.from_numpy(v) for f, v in frames.items()},
                                torch.from_numpy(K), fac, H, W, 4, 4)
    got = augment.augment_batch(
        {f: torch.from_numpy(v).to(dev) for f, v in frames.items()},
        torch.from_numpy(K).to(dev), {k: v.to(dev) for k, v in fac.items()},
        H, W, 4, 4)
    worst = {"colour": 0.0, "K": 0.0}
    for k, r in ref.items():
        g = got[k].cpu()
        if k[0] in ("K", "inv_K"):
            worst["K"] = max(worst["K"], ((g - r).abs().max() / r.abs().max()).item())
        else:
            worst["colour"] = max(worst["colour"], (g - r).abs().max().item())
    blank = got[("color_aug", -1, 0)][3].abs().max().item()
    print(f"fast pipeline: augment_batch B={B} {W}x{H}, 3 frames, 4 scales, "
          f"card vs CPU: colours max|d|={worst['colour']:.3e} (tol {AUG_TOL:g}), "
          f"K / inv_K max rel {worst['K']:.3e} (tol 1e-5); blank frame "
          f"max {blank}")
    if not (worst["colour"] <= AUG_TOL and worst["K"] <= 1e-5 and blank == 0):
        raise AssertionError("fast pipeline: the card's augment disagrees")
    u8 = {f: (v * 255).astype(np.uint8) for f, v in frames.items()}
    gen = torch.Generator(dev).manual_seed(SEED)
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prepare_batch(u8, K, gen, H, W, 4, 1, dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"fast pipeline: prepare_batch B={B} {W}x{H} 3 frames u8 (upload, "
          f"/255, augment, K): median {np.median(times[1:]):.3f} ms, all "
          f"{[round(t, 3) for t in times]} ms")

    t0 = time.perf_counter()
    libjpeg = NL.find_libjpeg()
    path = NL.build()
    needed = [line.split("[")[1].rstrip("]") for line in subprocess.run(
        ["readelf", "-d", str(path)], capture_output=True, text=True,
        check=True).stdout.splitlines() if "(NEEDED)" in line]
    print(f"fast pipeline: native loader {path} built in "
          f"{time.perf_counter() - t0:.2f} s (g++ "
          f"{NL.build_log.get('seconds', 0.0):.2f} s) by: "
          f"{' '.join(NL.command(str(path), libjpeg))}; it needs {needed}")
    if (path.parent != NL.BUILD_DIR or NL.BUILD_DIR.parent.name != "build"
            or libjpeg.name not in needed):
        raise AssertionError(f"fast pipeline: library at {path}, needing "
                             f"{needed}, not Pillow's {libjpeg}")
    with tempfile.TemporaryDirectory() as tmp:
        arr = (rng.rand(128, 192, 3) * 255).astype(np.uint8)
        for _ in range(4):
            arr = (arr.astype(np.float32) / 2 + np.roll(arr, 1, 0) / 4
                   + np.roll(arr, 1, 1) / 4).astype(np.uint8)
        p = os.path.join(tmp, "img.jpg")
        Image.fromarray(arr).save(p, quality=95)
        full = NL.decode_resize(p, 192, 128)
        pil = np.asarray(Image.open(p).convert("RGB"))
        small = NL.decode_resize(p, 96, 64)
        pil_small = np.asarray(Image.open(p).convert("RGB").resize(
            (96, 64), Image.BILINEAR)).astype(np.float32)
        batch = NL.decode_resize_batch([p, os.path.join(tmp, "missing.jpg")],
                                       96, 64, 2)
        mad = np.abs(small.astype(np.float32) - pil_small).mean()
        print(f"fast pipeline: decode at the native size equal to PIL's "
              f"{np.array_equal(full, pil)}; resized mean |d| vs PIL bilinear "
              f"{mad:.3f} (tol 12); missing file blank {not batch[1].any()}")
        if not (np.array_equal(full, pil) and mad < 12.0 and not batch[1].any()
                and np.array_equal(batch[0], small)):
            raise AssertionError("fast pipeline: the native decode disagrees with PIL")


def train_cli_fast(classic_rate):
    """The training CLI of `train_cli` under `--fast_pipeline --decode_cache
    cache` (name "fast"), in-process, with its checks (`_check_cli_run`):
    the decode cache's files exist and every frame is present when epoch 1
    starts; its loop rate beside the threaded loader's (`classic_rate`,
    images/s). Returns the run's counts."""
    import os

    import torch

    from ppeadepth_tpu_torch.data import fast_pipeline

    args = _cli_args(["--compute_dtype", "bfloat16", "--weights_init", "scratch",
                      "--num_epochs", str(TRAIN_EPOCHS), "--validate_every",
                      str(VALIDATE_EVERY), "--log_dir", "ckpt", "--name", "fast",
                      "--pytorch_random_seed", "0", "--load_weights_folder", "seed",
                      "--fast_pipeline", "--decode_cache", "cache"])
    print("fast CLI: python -m ppeadepth_tpu_torch.train " + " ".join(args))
    pipeline = fast_pipeline.FastDecodePipeline
    set_epoch, cache_at = pipeline.set_epoch, {}

    def recording(self, epoch):
        c = self.cache
        cache_at[epoch] = (int(c.present.sum()), len(c.present),
                           os.path.isfile(c.data_path))
        return set_epoch(self, epoch)

    pipeline.set_epoch = recording
    steps, vals = [], []
    try:
        trainer, wall, counts = _run_cli(args, steps, vals)
    finally:
        pipeline.set_epoch = set_epoch
    peak = torch.cuda.max_memory_allocated()
    n_steps = TRAIN_EPOCHS * N_TRAIN // EVAL_BATCH
    _check_cli_run("fast CLI", TRAIN_B, trainer, steps, counts, n_steps,
                   VALIDATE_EVERY, N_TEST, os.path.join("ckpt", "fast"), "fast")
    present, n, exists = cache_at.get(1, (0, 0, False))
    print(f"fast CLI: decode cache at the start of epoch 1: {present} of {n} "
          f"frames present, data file {exists}; "
          f"{sorted(os.listdir('cache'))}")
    if not (exists and n and present == n and cache_at[0][0] == 0):
        raise AssertionError(f"fast CLI: decode cache {cache_at}")
    rate = _loop_rate("fast CLI", steps, vals, wall, peak)
    print(f"fast CLI: --fast_pipeline {rate / EVAL_BATCH:.3f} steps/s against "
          f"the threaded loader's {classic_rate / EVAL_BATCH:.3f} in this run "
          f"({rate / classic_rate:.3f}x)")
    return counts


def _category(name):
    n = name.lower()
    for key, cat in (("lk_dwconv", "kernel A (lk_dwconv; forward and dx)"),
                     ("ffn_", "kernel B (ffn_gemm_kernel, up + down)"),
                     ("plane_sweep", "kernel C (plane_sweep)"),
                     ("warp_fwd_kernel", "kernel D (warp_border; forward and backward)"),
                     ("warp_bwd_kernel", "kernel D (warp_border; forward and backward)"),
                     ("memcpy htod", "memcpy host -> device"),
                     ("memcpy dtoh", "memcpy device -> host"),
                     ("reflection_pad", "reflection pad (decoder)"),
                     ("batch_norm", "batch norm"), ("bn_fw", "batch norm"),
                     ("bn_bw", "batch norm"),
                     ("adam", "Adam update"), ("multi_tensor", "Adam update"),
                     ("upsample", "upsample + cat"), ("catarray", "upsample + cat"),
                     ("reduce", "reductions (cost-volume max/sum/argmin, means)"),
                     ("index", "gather/index"), ("max_pool", "max pool")):
        if key in n:
            return cat
    if any(k in n for k in ("conv", "gemm", "xmma", "cutlass", "cudnn",
                            "nchw", "nhwc", "implicit", "sm90", "winograd")):
        return "cuDNN/cuBLAS convs and GEMMs (incl. layout transposes)"
    return "other elementwise"


def _union_us(spans, lo=float("-inf"), hi=float("inf")):
    """Length of the union of sorted (start, end) intervals inside [lo, hi]."""
    total, end = 0.0, lo
    for s, e in spans:
        if s >= hi:
            break
        e = min(e, hi)
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def _phase_us(host, device, kernels):
    """(host, device, busy) microseconds of one phase span: its host ranges
    summed; the union of its device-side copies (the profiler may keep
    several for one range, one a stream, and they overlap); the union of
    the sorted `kernels` intervals inside that union."""
    merged = []
    for s, e in sorted(device):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return (sum(e - s for s, e in host), sum(e - s for s, e in merged),
            sum(_union_us(kernels, s, e) for s, e in merged))


def profile_serving(tag, fn, requests):
    """torch.profiler over 5 calls (batches or training steps): device time
    by kernel category and of the 5 costliest kernels, device busy (union
    of kernel intervals) and the host wall; then each of the port's phase
    spans (`ppea:` ranges, `ppeadepth_tpu_torch.utils.trace`): its host
    time and, over the device-side copies the profiler keeps of it on a
    card (user annotations, never kernels), its device time and the busy
    time of the kernels inside (`_phase_us`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ppeadepth_tpu_torch.utils.trace import PREFIX

    fn(*requests[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(5):
            fn(*requests[i % len(requests)])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 5
    spans, cats, names, phases = [], {}, {}, {}
    for e in prof.events():
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        r = e.time_range
        if e.name.startswith(PREFIX):
            side = phases.setdefault(e.name, ([], []))[on_device]
            side.append((r.start, r.end))
            continue
        if not on_device or getattr(e, "is_user_annotation", False):
            continue
        spans.append((r.start, r.end))
        for key, acc in ((_category(e.name), cats), (e.name, names)):
            c = acc.setdefault(key, [0.0, 0])
            c[0] += (r.end - r.start) / 1e3 / 5
            c[1] += 1
    if not spans:
        raise AssertionError(f"profile {tag}: the trace holds no device time")
    spans.sort()
    busy = _union_us(spans) / 1e3 / 5
    total = sum(v[0] for v in cats.values())
    print(f"profile {tag}: per batch, device busy {busy:.3f} ms, host wall "
          f"{wall:.3f} ms under the profiler, idle share {1 - busy / wall:.4f}")
    for cat, (ms, n) in sorted(cats.items(), key=lambda kv: -kv[1][0]):
        print(f"profile {tag}: {cat}: {ms:.3f} ms/batch, {100 * ms / total:.1f} % "
              f"of device time, {n / 5:g} kernels/batch")
    for name, (ms, n) in sorted(names.items(), key=lambda kv: -kv[1][0])[:5]:
        print(f"profile {tag}: top kernel {ms:.3f} ms/batch, {n / 5:g}/batch: "
              f"{name[:120]}")
    for name, (host, device) in sorted(phases.items()):
        host_ms, dev_ms, dev_busy = (
            t / 1e3 / 5 for t in _phase_us(host, device, spans))
        print(f"profile {tag}: phase {name}: {len(host) / 5:g}/batch, host "
              f"{host_ms:.3f} ms/batch; on the device {len(device) / 5:g} "
              f"copies/batch over {dev_ms:.3f} ms/batch, kernels busy "
              f"{dev_busy:.3f} ms/batch")


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "the port's smoke run needs a CUDA card")
    args = sys.argv[1:]
    if args[:1] == ["--dp_rank"] and len(args) > 2:
        dp_rank(args[1], args[2:])
        return
    only = args[args.index("--kernel") + 1] if "--kernel" in args[:-1] else None
    if "--kernel" in args and only not in ("A", "B", "C", "D"):
        raise SystemExit("chip_smoke: --kernel takes A, B, C or D (that "
                         "kernel's checks alone)")
    import numpy as np

    from ppeadepth_tpu_torch.kernels import build
    from ppeadepth_tpu_torch.serve import InferenceSession

    t_run = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")
    print(f"device: {name}, count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    # the CPU f32 references and the plain versions compare in full f32;
    # the pose net turns TF32 off itself (models.repdepth.RepDepth.pose_pair)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{build.build_log.get('seconds', 0.0):.2f} s) -> {build.BUILD_DIR}")
    for line in build.build_log.get("ptxas", "").splitlines():
        if any(key in line for key in ("registers", "Compiling entry", "spill")):
            print("ptxas:", line.strip())

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED)
    if only == "A":
        _clocks("before the checks")
        res = {"kernel A (teacher)": check_lk_dwconv(dev, rng),
               "kernel #2": check_lk_train(dev, rng),
               "kernel #3": check_lk_pallas(dev, rng)}
        _clocks("after the checks")
        profile_lk_banded(dev, rng, sweep="--sweep" in args)
        _clocks("after the banded stages")
        profile_lk_launches(dev, rng)
        _clocks("after the launch profile")
        if "--sweep" in args:
            sweep_lk_plans(dev, rng)
            _clocks("after the sweep")
        print(json.dumps({"kernel A only": res}))
        return
    if only == "B":
        b = check_ffn_fused(dev, rng)
        profile_ffn_launches(dev, rng)
        print(json.dumps({"kernel B only": b}))
        return
    if only == "C":
        _clocks("before the checks")
        res = {"check": check_plane_sweep(dev, rng),
               "launches": time_plane_sweep(dev, rng, "--sweep" in args)}
        _clocks("after the times")
        print(json.dumps({"kernel C only": res}))
        return
    if only == "D":
        _clocks("before the checks")
        res = {"check": check_warp(dev, rng),
               "launches": time_warp(dev, rng, "--sweep" in args)}
        _clocks("after the times")
        print(json.dumps({"kernel D only": res}))
        return
    a = check_lk_dwconv(dev, rng)
    b = check_ffn_fused(dev, rng)
    c = check_plane_sweep(dev, rng)
    d = check_warp(dev, rng)
    lk2 = check_lk_train(dev, rng)
    lk3 = check_lk_pallas(dev, rng)
    # the kernels of the stage-2 step at its 512x192 shapes
    lk2_cs = check_lk_train(dev, rng, STAGE2_B)
    c_cs = check_plane_sweep(dev, rng, TRAIN_BATCH, STAGE2_B)
    d_cs = check_warp(dev, rng, STAGE2_B)
    # the DDAD eval's: #3 and C (f32) at 320x480; and the --dyn_cv volume
    lk3_ddad = check_lk_pallas(dev, rng, DDAD_B, N_DDAD)
    c_ddad = check_plane_sweep(dev, rng, EVAL_BATCH, DDAD_B, (torch.float32,))
    check_dyn_volume(dev, rng)
    # the legacy eval's C (f32, C=64) and a --grad_accum 2 microbatch's
    # shapes of #2, C and D (B=6, stage 1)
    c_ori = check_plane_sweep(dev, rng, EVAL_BATCH, SHIPPED_B, (torch.float32,),
                              channels=64)
    lk2_mb = check_lk_train(dev, rng, TRAIN_B, MICRO_BATCH)
    c_mb = check_plane_sweep(dev, rng, MICRO_BATCH, SHIPPED_B, (torch.bfloat16,))
    d_mb = check_warp(dev, rng, SHIPPED_B, MICRO_BATCH)
    check_fast_pipeline(dev)
    # adpt_test 2's ConvFFN adapter is C/2 wide: kernel B at a 4.5C hidden
    b2 = check_ffn_fused(dev, rng, adapter_div=2)

    opt = SHIPPED_B
    sd = _random_state_dict(opt)
    t0 = time.perf_counter()
    sess = InferenceSession(opt, sd, device="cuda", dtype="bfloat16",
                            min_depth_bin=DEPTH_BINS[0], max_depth_bin=DEPTH_BINS[1])
    print(f"serve: session built in {time.perf_counter() - t0:.2f} s")
    cpu = InferenceSession(opt, sd, device="cpu", dtype="float32",
                           min_depth_bin=DEPTH_BINS[0], max_depth_bin=DEPTH_BINS[1])
    img_rng = np.random.RandomState(SEED + 1)
    requests = []
    for _ in range(REQUESTS):
        img = img_rng.rand(BATCH, opt.height, opt.width, 3).astype("float32")
        # the previous frame: the current one shifted by a few pixels, so the
        # plane sweep sees structure
        requests.append((img, np.roll(img, (2, 5), (1, 2)).copy()))

    by_path = {"predict_depth": serve_teacher(sess, cpu, opt, requests),
               "predict_depth_multi": serve_student(sess, cpu, opt, requests),
               "predict_pose": serve_pose(sess, cpu, requests)}
    profile = "--profile" in args
    if profile:
        K, invK = _kitti_K(opt.height // 4, opt.width // 4, BATCH)
        profile_serving("predict_depth_multi",
                        lambda img, lk: sess.predict_depth_multi(img, lk, K, invK),
                        requests)
        profile_serving("predict_depth", lambda img, _: sess.predict_depth(img),
                        requests)
    del sess, cpu
    walls = {}
    train_parity(sd, dev)
    by_path["train_step"] = train_steps(sd, dev, profile, walls=walls)
    # --grad_accum 2: the stage-1 step as two microbatches of 6
    train_parity(sd, dev, ACCUM_B, "accum parity", ACCUM_PARITY_BATCH)
    by_path["train_step_accum"] = train_steps(sd, dev, False, ACCUM_B, "accum",
                                              ACCUM_STEPS, walls)
    (m1, p1), (m2, p2) = walls["train"], walls["accum"]
    print(f"--grad_accum 2 against stage 1 (B={TRAIN_BATCH}, bf16, this run): "
          f"median {m2:.3f} against {m1:.3f} ms/step ({m2 / m1:.3f}x), peak "
          f"{p2 / 2**30:.3f} against {p1 / 2**30:.3f} GiB; launches a step "
          f"{by_path['train_step_accum']} against {by_path['train_step']}")
    sd2 = _stage2_state_dict(sd, STAGE2_B)
    train_parity(sd2, dev, STAGE2_B, "stage-2 parity")
    by_path["train_step_stage2"] = train_steps(sd2, dev, profile, STAGE2_B,
                                               "stage2")
    train_steps(sd2, dev, False, STAGE2_B.replace(grad_accum=2), "stage2 accum", 1)
    # --dyn_cv: the stage-2 network with the DynamicDepth volume
    train_parity(sd2, dev, DYN_B, "dyn parity")
    by_path["train_step_dyn"] = train_steps(sd2, dev, profile, DYN_B, "dyn")
    by_path.update(serve_drawn_adapters(sd2))
    del sd2
    # breadth: every adapter variant and the transition and input adapters,
    # served and trained (launches as stage 1's)
    t0 = time.perf_counter()
    sd_b = _random_state_dict(BREADTH_B)
    print(f"breadth: calibrated weights in {time.perf_counter() - t0:.2f} s")
    by_path.update(serve_breadth(sd_b))
    train_parity(sd_b, dev, TRAIN_BREADTH, "breadth parity")
    by_path["train_step_breadth"] = train_steps(
        sd_b, dev, False, TRAIN_BREADTH, "breadth", BREADTH_STEPS, walls)
    del sd_b
    (m1, p1), (mb, pb) = walls["train"], walls["breadth"]
    print(f"breadth against stage 1 (B={TRAIN_BATCH}, bf16, this run): median "
          f"{mb:.3f} against {m1:.3f} ms/step ({mb / m1:.3f}x), peak "
          f"{pb / 2**30:.3f} against {p1 / 2**30:.3f} GiB")
    if by_path["train_step_breadth"] != by_path["train_step"]:
        raise AssertionError(f"breadth: launches a step "
                             f"{by_path['train_step_breadth']}, stage 1's "
                             f"{by_path['train_step']}")

    # the CLI: training with validation and checkpoints, resume, and --eval,
    # on a synthetic KITTI set in a temporary directory
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        _kitti_set(root, np.random.RandomState(SEED + 5))
        _cityscapes_set(root, np.random.RandomState(SEED + 8))
        _ddad_set(root, np.random.RandomState(SEED + 9))
        print(f"synthetic KITTI, CityScapes and DDAD sets written in "
              f"{time.perf_counter() - t0:.2f} s")
        os.chdir(root)
        try:
            trainer, final, by_path["train_cli"], rate = train_cli(sd, dev)
            check_resume(trainer, final)
            del trainer
            by_path["eval_pallas"] = eval_cli(final, profile)
            by_path["ablation"] = ablation_cli(final)
            by_path["eval_ddad"] = eval_cli(final, False, "ddad")
            by_path["eval_ori"] = eval_ori_cli()
            by_path["eval_ori_r50"] = eval_ori_r50()
            by_path["dp_world1"], plain = dp_world1()
            by_path["dp_world2"] = dp_world2(plain)
            del plain
            by_path["train_cli_fast"] = train_cli_fast(rate)
            # stage 2 from the KITTI run's final checkpoint, its CityScapes
            # eval, and serving its checkpoint
            cs_final, by_path["train_cli_stage2"] = train_cli_stage2(final)
            by_path["eval_cityscapes"] = eval_cli(cs_final, False, "cityscapes")
            by_path.update(serve_stage2(cs_final))
            by_path.update(serve_dyn(cs_final))
        finally:
            os.chdir(cwd)

    # #6 at the stage-2 shape: one entry, the forward, with the backward's
    # numbers beside it
    d_cs_entry = dict(d_cs["forward"], **{
        f"backward_{k}": v for k, v in d_cs["backward"].items()},
        backward_launches=by_path["train_step_stage2"]["warp_bwd"])
    d_mb_entry = dict(d_mb["forward"], **{
        f"backward_{k}": v for k, v in d_mb["backward"].items()},
        backward_launches=by_path["train_step_accum"]["warp_bwd"])
    entries = []
    for entry, kname, src, replaces, res, per, path in (
            ("lk_dwconv", "lk_dwconv", "lk_dwconv.cu", "banded_conv.py:287", a,
             "teacher forward (24 calls)", "predict_depth_multi"),
            ("ffn_fused", "ffn_fused", "ffn_fused.cu", "ffn_mxu.py:201", b,
             "teacher forward (24 calls)", "predict_depth_multi"),
            ("ffn_fused (adpt_test 2)", "ffn_fused", "ffn_fused.cu",
             "ffn_mxu.py:201", b2,
             "teacher forward (24 calls) of adpt_test 2: the ConvFFN adapter "
             "C/2 wide, a packed hidden of 4.5C", "predict_depth_breadth_2"),
            ("plane_sweep", "plane_sweep", "plane_sweep.cu",
             "cost_volume_mxu.py:149", c,
             "call (one per student request)", "predict_depth_multi"),
            ("warp_fwd", "warp_fwd", "warp_border.cu", "warp_mxu.py:269",
             d["forward"], "call ([24,192,640,3], one per branch)", "train_step"),
            ("warp_bwd", "warp_bwd", "warp_border.cu", "warp_mxu.py:269",
             d["backward"], "call ([24,192,640,3], one per branch)", "train_step"),
            ("lk_dwconv_dx", "lk_dwconv_dx", "lk_dwconv.cu", "banded_conv.py:152",
             lk2, "training step, bf16 (100 forward + 96 dx calls of kernel A)",
             "train_step"),
            ("lk_dwconv (kernel #3)", "lk_dwconv", "lk_dwconv.cu",
             "lk_conv_pallas.py:70", lk3,
             "f32 eval batch of 12 under --lk_backend pallas (157 calls of "
             "kernel A)", "eval_pallas"),
            ("lk_dwconv_dx (stage 2)", "lk_dwconv_dx", "lk_dwconv.cu",
             "banded_conv.py:152", lk2_cs,
             "stage-2 training step at 512x192, bf16 (100 forward + 96 dx "
             "calls of kernel A)", "train_step_stage2"),
            ("plane_sweep (stage 2)", "plane_sweep", "plane_sweep.cu",
             "cost_volume_mxu.py:149", c_cs,
             "call ([12,48,128,128] bf16, one per stage-2 step)",
             "train_step_stage2"),
            ("warp_fwd (stage 2)", "warp_fwd", "warp_border.cu",
             "warp_mxu.py:269", d_cs_entry,
             "call ([24,192,512,3], one per branch; backward_* the "
             "backward's)", "train_step_stage2"),
            ("lk_dwconv (kernel #3, DDAD)", "lk_dwconv", "lk_dwconv.cu",
             "lk_conv_pallas.py:70", lk3_ddad,
             f"f32 eval batch of 12 at 320x480 under --lk_backend pallas "
             f"({sum(c[4] for c in _eval_lk_calls(DDAD_B))} calls of kernel A)",
             "eval_ddad"),
            ("plane_sweep (DDAD)", "plane_sweep", "plane_sweep.cu",
             "cost_volume_mxu.py:149", c_ddad,
             "call ([12,80,120,128] f32, two per DDAD eval batch)", "eval_ddad"),
            ("plane_sweep (legacy eval)", "plane_sweep", "plane_sweep.cu",
             "cost_volume_mxu.py:149", c_ori,
             "call ([12,48,160,64] f32, one per legacy eval batch)", "eval_ori"),
            ("lk_dwconv_dx (grad_accum 2)", "lk_dwconv_dx", "lk_dwconv.cu",
             "banded_conv.py:152", lk2_mb,
             "microbatch (B=6, bf16) of a --grad_accum 2 step: 100 forward + "
             "96 dx calls of kernel A; the step runs two", "train_step_accum"),
            ("plane_sweep (grad_accum 2)", "plane_sweep", "plane_sweep.cu",
             "cost_volume_mxu.py:149", c_mb,
             "call ([6,48,160,128] bf16, one per microbatch)", "train_step_accum"),
            ("warp_fwd (grad_accum 2)", "warp_fwd", "warp_border.cu",
             "warp_mxu.py:269", d_mb_entry,
             "call ([12,192,640,3], one per branch per microbatch; backward_* "
             "the backward's)", "train_step_accum")):
        entries.append({
            "name": entry, "route": "cuda",
            "source": f"ppeadepth_tpu_torch/csrc/{src}",
            "replaces": f"ppeadepth_tpu/kernels/{replaces}",
            "launches": by_path[path][kname], "max_abs_err": res["max_abs_err"],
            "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            "library_ms": res["library_ms"], "times_per": per, "path": path,
            **{k: v for k, v in res.items() if k.startswith("backward_")
               or k == "cublas_products_ms"},
            "launches_by_path": {p: n[kname] for p, n in by_path.items()}})
    print(f"chip_smoke: the whole run took {time.perf_counter() - t_run:.2f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
