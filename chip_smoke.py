#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives the port's teacher serving path (`ppeadepth_tpu_torch.serve.
InferenceSession.predict_depth`: RepLKNet-31B + PEA adapters, adpt_test=4,
640x192, bf16, merged deploy form, B=8) on seeded random weights, after
building the hand-written kernels from `ppeadepth_tpu_torch/csrc/` and
holding each against its plain PyTorch version at every shape the path
gives it. Any failed phase raises, so the exit code is non-zero; without a
CUDA device it stops before doing anything.

Output, in order: versions and the card's name and power limit; the kernel
build; per-shape kernel errors and times; the serving checks and times; one
JSON line with the kernels' summary; and as the last line
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from types import SimpleNamespace

SEED = 0
BATCH = 8
REQUESTS = 3
A_REL_TOL = 1e-2        # kernel A: max|d| <= 1e-2 * max|ref| (bf16 output)
B_MAX_REL_TOL = 2.5e-2  # kernel B: tests/test_ffn_mxu.py:63-67 bounds
B_MEAN_REL_TOL = 3e-3
DISP_MEAN_TOL = 5e-3    # bf16 card forward vs CPU f32 forward, |d disp|
DISP_MAX_TOL = 5e-2

# The shipped teacher config (ckpt/models/opt.json: --adapter --rep_size b,
# adpt_test 4) at KITTI 640x192, under `ppeadepth_tpu.options.Config`'s
# field names and defaults. Spelled out so this script imports nothing of
# the JAX package.
TEACHER_B = SimpleNamespace(
    adapter=True, rep_size="b", adpt_test=4, ratio=0.25, g_blk=1.0,
    g_ffn=1.0, mono_trans=False, mono_input=False, dc=False,
    height=192, width=640, min_depth=0.1, max_depth=100.0)


def _time_pair(plain, kernel, iters):
    """Warm CUDA-event times (ms per call) in turns plain, kernel, kernel,
    plain; returns (plain_ms, kernel_ms), each the mean of its two turns."""
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

    plain()
    kernel()
    torch.cuda.synchronize()
    p1, k1, k2, p2 = run(plain), run(kernel), run(kernel), run(plain)
    return (p1 + p2) / 2, (k1 + k2) / 2


def _stage_shapes():
    """(C, H, W, k, blocks) of the four encoder stages at 640x192."""
    from ppeadepth_tpu_torch.models.replknet import REPLK_CONFIGS

    cfg = REPLK_CONFIGS["b"]
    return [(cfg["channels"][i], 192 // 4 >> i, 640 // 4 >> i,
             cfg["large_kernel_sizes"][i], cfg["layers"][i])
            for i in range(4)]


def _dw_macs(B, H, W, C, k):
    """Multiply-adds a SAME depthwise conv needs once taps that fall on
    padding are dropped (what the kernel's tap clipping aims at)."""
    def taps(n):
        h = k // 2
        return sum(min(n - 1, o + h) - max(0, o - h) + 1 for o in range(n))

    return B * C * taps(H) * taps(W)


def check_lk_dwconv(dev, rng):
    """Kernel A against its plain version at the four stage shapes."""
    import torch

    from ppeadepth_tpu_torch.kernels.lk_conv import depthwise_plain, lk_depthwise

    worst, ms, plain_ms = 0.0, 0.0, 0.0
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
        print(f"kernel A  [{BATCH},{H},{W},{C}] k={k}: {kk:.4f} ms/call "
              f"({macs / kk / 1e9:.2f} T multiply-adds/s of {macs / 1e9:.2f} G), "
              f"plain (cuDNN bf16) {p:.4f} ms/call, x{blocks} per forward")
        ms += kk * blocks
        plain_ms += p * blocks
    return worst, ms, plain_ms


def check_ffn_fused(dev, rng):
    """Kernel B against its plain version at the four stage shapes, with
    the adapter (the main path) and without it."""
    import torch

    from ppeadepth_tpu_torch.kernels.ffn_fused import (
        FoldedFFN, ffn_fused, ffn_fused_plain)

    def t(shape, scale, dtype=torch.bfloat16):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype("float32")).to(dev).to(dtype)

    worst, ms, plain_ms = 0.0, 0.0, 0.0
    cases = [(C, H, W, blocks, True) for C, H, W, _, blocks in _stage_shapes()]
    cases += [c[:4] + (False,) for c in cases]
    for C, H, W, blocks, adapter in cases:
        M, H4, CA = BATCH * H * W, 4 * C, C // 4
        f32 = torch.float32
        p = FoldedFFN(t((C, H4), C ** -0.5), t((H4,), 0.1, f32),
                      t((H4, C), H4 ** -0.5), t((C,), 0.1, f32),
                      *((t((C, CA), C ** -0.5), t((CA,), 0.1, f32),
                         t((CA, C), CA ** -0.5), t((C,), 0.1, f32))
                        if adapter else ()))
        x = t((BATCH, H, W, C), 1.0).permute(0, 3, 1, 2)
        y = ffn_fused(x, p)
        torch.cuda.synchronize()
        pf = FoldedFFN(*(v.float() if v is not None else None for v in p))
        x2d = x.permute(0, 2, 3, 1).reshape(M, C)
        ref = ffn_fused_plain(x2d.float(), pf)
        diff = (y.permute(0, 2, 3, 1).reshape(M, C).float() - ref).abs()
        scale = ref.abs().max().item()
        mx, mean = diff.max().item(), diff.mean().item()
        tag = f"kernel B  [{M},{C}] adapter={adapter}"
        print(f"{tag}: max|d|={mx:.3e} max rel {mx / scale:.3e} "
              f"mean rel {mean / scale:.3e} (tol {B_MAX_REL_TOL:g} / "
              f"{B_MEAN_REL_TOL:g})")
        if not (mx / scale < B_MAX_REL_TOL and mean / scale < B_MEAN_REL_TOL):
            raise AssertionError(f"kernel B disagrees at C={C}: {mx}, {mean}")
        worst = max(worst, mx)
        pl, kk = _time_pair(lambda: ffn_fused_plain(x2d, p),
                            lambda: ffn_fused(x, p), 20)
        flop = 2 * M * C * (2 * H4 + (2 * CA if adapter else 0))
        print(f"{tag}: {kk:.4f} ms/call ({flop / kk / 1e9:.1f} TFLOP/s), "
              f"plain (cuBLAS bf16) {pl:.4f} ms/call, x{blocks} per forward")
        if adapter:
            ms += kk * blocks
            plain_ms += pl * blocks
    return worst, ms, plain_ms


def _random_state_dict(opt):
    """Seeded random teacher weights in training form.

    Conv/linear weights come from `init_weights`; adapter `D_fc2` weights
    are drawn from a numpy seed (not zero) so the adapter branches count.
    BN running statistics are then calibrated by one train-mode forward of
    seeded random images, as a trained network's statistics match its own
    activations: with arbitrary statistics each eval-mode residual block
    scales its input, and the 36 blocks of RepLKNet-31B grow activations
    ~1000x, where bf16 and f32 then disagree for reasons that are not the
    kernels'. For the same reason the last BN scale of every residual
    branch (`pw2.bn.weight`) is drawn small, as in trained residual nets
    whose branches add small updates to the trunk; with unit scales the
    random 36-block net amplifies bf16 rounding chaotically. Finally the
    statistics are perturbed from the numpy seed, so the BN folding is
    exercised with non-trivial values."""
    import numpy as np
    import torch

    from ppeadepth_tpu_torch.models import RepDepth, init_weights

    model = RepDepth(opt)
    init_weights(model, torch.Generator().manual_seed(SEED))
    rng = np.random.RandomState(SEED)

    def draw(shape, scale):
        return torch.from_numpy(rng.randn(*shape).astype("float32") * scale)

    with torch.no_grad():
        for name, p in model.named_parameters():
            if "D_fc2" in name and name.endswith("weight"):
                p.copy_(draw(p.shape, 0.05))
            elif name.endswith("pw2.bn.weight"):
                p.copy_(torch.from_numpy(
                    rng.rand(*p.shape).astype("float32") * 0.05 + 0.05))
        bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
        for m in bns:
            m.reset_running_stats()
            m.momentum = None  # one pass: running stats = batch stats
        calib = torch.from_numpy(
            rng.rand(2, 3, opt.height, opt.width).astype("float32"))
        model.train()
        model.forward_mono(calib.contiguous(memory_format=torch.channels_last))
        model.eval()
        for m in bns:
            m.momentum = 0.1
            std = m.running_var.sqrt()
            m.running_mean += draw(std.shape, 0.05) * std
            m.running_var *= torch.from_numpy(
                rng.rand(*std.shape).astype("float32") * 0.4 + 0.8)
    return model.state_dict()


def serve(opt):
    """Answer REQUESTS batches on the card through the kernels; check the
    outputs, the launch counts and agreement with the CPU f32 forward."""
    import numpy as np
    import torch

    from ppeadepth_tpu_torch import kernels
    from ppeadepth_tpu_torch.serve import InferenceSession

    sd = _random_state_dict(opt)
    t0 = time.perf_counter()
    sess = InferenceSession(opt, sd, device="cuda", dtype="bfloat16")
    print(f"serve: session built in {time.perf_counter() - t0:.2f} s")
    rng = np.random.RandomState(SEED + 1)
    requests = [rng.rand(BATCH, opt.height, opt.width, 3).astype("float32")
                for _ in range(REQUESTS)]
    blocks = sum(s[4] for s in _stage_shapes())

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    depths = [sess.predict_depth(img) for img in requests]
    counts = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    print(f"serve: {REQUESTS} requests of B={BATCH}, launches {counts}")
    for name in ("lk_dwconv", "ffn_fused"):
        if counts[name] != blocks * REQUESTS:
            raise AssertionError(f"{name}: {counts[name]} launches, expected "
                                 f"{blocks} per request")
    for d in depths:
        if d.shape != (BATCH, opt.height, opt.width):
            raise AssertionError(f"depth shape {d.shape}")
        if not np.isfinite(d).all():
            raise AssertionError("non-finite depth")
        if d.min() < opt.min_depth * (1 - 1e-3) or d.max() > opt.max_depth * (1 + 1e-3):
            raise AssertionError(f"depth outside [{opt.min_depth}, "
                                 f"{opt.max_depth}]: {d.min()} .. {d.max()}")
    print(f"serve: depth shape {depths[0].shape}, finite, in "
          f"[{min(d.min() for d in depths):.4f}, "
          f"{max(d.max() for d in depths):.4f}]")

    # one image against the port's own CPU float32 forward (plain versions)
    cpu = InferenceSession(opt, sd, device="cpu", dtype="float32")
    t0 = time.perf_counter()
    ref = cpu.predict_depth(requests[0][:1])
    print(f"serve: CPU f32 forward of one image in {time.perf_counter() - t0:.2f} s")

    def disp(depth):
        lo, hi = 1.0 / opt.max_depth, 1.0 / opt.min_depth
        return (1.0 / depth - lo) / (hi - lo)

    dd = np.abs(disp(depths[0][:1]) - disp(ref))
    print(f"serve: |d disp| vs CPU f32 mean {dd.mean():.3e} max {dd.max():.3e} "
          f"(tol {DISP_MEAN_TOL:g} / {DISP_MAX_TOL:g}); disp range "
          f"[{disp(ref).min():.4f}, {disp(ref).max():.4f}]")
    if not (dd.mean() <= DISP_MEAN_TOL and dd.max() <= DISP_MAX_TOL):
        raise AssertionError("card forward disagrees with the CPU forward")

    # request latency: host clock around predict_depth, which returns host
    # numpy (so the device work is finished)
    times = []
    for i in range(10):
        t0 = time.perf_counter()
        sess.predict_depth(requests[i % REQUESTS])
        times.append(time.perf_counter() - t0)
    med = float(np.median(times)) * 1e3
    print(f"serve: predict_depth B={BATCH} 640x192 bf16: median {med:.3f} ms/batch "
          f"({BATCH / med * 1e3:.2f} images/s), all {[round(t * 1e3, 3) for t in times]} ms")
    print(f"serve: peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    return counts


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "the port's smoke run needs a CUDA card")
    import numpy as np

    from ppeadepth_tpu_torch.kernels import build

    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")
    print(f"device: {name}, count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{build.build_log.get('seconds', 0.0):.2f} s) -> {build.BUILD_DIR}")
    for line in build.build_log.get("ptxas", "").splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("ptxas:", line.strip())

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED)
    a_err, a_ms, a_plain = check_lk_dwconv(dev, rng)
    b_err, b_ms, b_plain = check_ffn_fused(dev, rng)

    counts = serve(TEACHER_B)

    print(json.dumps({"kernels": [
        {"name": "lk_dwconv", "route": "cuda",
         "source": "ppeadepth_tpu_torch/csrc/lk_dwconv.cu",
         "replaces": "ppeadepth_tpu/kernels/banded_conv.py:287",
         "launches": counts["lk_dwconv"], "max_abs_err": a_err,
         "ms": a_ms, "plain_ms": a_plain},
        {"name": "ffn_fused", "route": "cuda",
         "source": "ppeadepth_tpu_torch/csrc/ffn_fused.cu",
         "replaces": "ppeadepth_tpu/kernels/ffn_mxu.py:201",
         "launches": counts["ffn_fused"], "max_abs_err": b_err,
         "ms": b_ms, "plain_ms": b_plain},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
