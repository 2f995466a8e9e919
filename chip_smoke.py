#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py              # the checks below
    python3 chip_smoke.py --profile    # and a torch.profiler breakdown of
                                       # each path's device time

Drives the port's serving paths (`ppeadepth_tpu_torch.serve.
InferenceSession`) at the shipped configuration (RepLKNet-31B + PEA
adapters, adpt_test=4, 640x192, bf16, merged deploy form, B=8, 96 depth
bins, ResNet-18 pose net) and its stage-1 training step
(`ppeadepth_tpu_torch.train.step.make_train_step`, the same network in
training form, bf16 compute on f32 parameters, B=12) on seeded random
weights, after building the hand-written kernels from
`ppeadepth_tpu_torch/csrc/` and holding each against its plain PyTorch
version at the shapes the paths give it:

  * teacher `predict_depth`, 3 requests, against the CPU f32 forward;
  * student `predict_depth_multi`, 3 requests, against the CPU f32 forward;
  * `predict_pose`, 3 pairs, against the CPU f32 result;
  * one f32 training step at B=2 against the same step on the CPU;
  * 1 + 5 bf16 training steps at B=12 with their invariants checked.

Each path runs with the kernels' launch counts set to 0 just before it and
read just after. Any failed phase raises, so the exit code is non-zero;
without a CUDA device it stops before doing anything.

Output, in order: versions and the card's name and power limit; the kernel
build; per-shape kernel errors and times; the serving checks and times; the
training checks and times; one JSON line with the kernels' summary; and as
the last line `{"ok": true, "device": {...}}`.
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
C_REL_TOL = 5e-5        # kernel C: the JAX mxu_f32 check's bound ...
C_BEYOND = 1e-5         # ... with at most this share of entries beyond it,
C_NEAR_PX = 1e-4        # each within this many px of an edge-mask boundary
DISP_MEAN_TOL = 5e-3    # bf16 card forward vs CPU f32 forward, |d disp|
DISP_MAX_TOL = 5e-2
POSE_TOL = 1e-4         # f32 card pose vs CPU f32 pose, max |d|
DEPTH_BINS = (0.1, 10.0)  # the JAX session's default min/max depth bin
D_FWD_TOL = 1e-5        # kernel D forward: max|d| (images in [0, 1])
D_BWD_REL_TOL = 1e-5    # kernel D coordinate gradient: max|d| <= tol x max|ref|
A_F32_REL_TOL = 1e-4    # kernel A in f32 (forward, dx): max|d| <= tol x max|ref|
TRAIN_BATCH = 12        # bench.py's train-step batch
TRAIN_STEPS = 5         # timed, after one warm-up step
PARITY_BATCH = 2        # the f32 card step against the f32 CPU step
PARITY_METRIC_TOL = 1e-3  # |d| of the loss and each metric (values ~0.1-1)
PARITY_GRAD_L2 = 1e-2   # relative L2 of the concatenated trainable gradient
PARITY_BIN_REL = 1e-4   # depth bins after the step, relative

# H100 SXM data-sheet peaks (dense, 700 W): the bound of each kernel is
# max(bytes / memory rate, operations / peak rate of their type)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12      # CUDA cores, float32
BF16_FLOP_PER_S = 989e12    # tensor cores, bf16

# The shipped config (ckpt/models/opt.json: --adapter --rep_size b,
# adpt_test 4) at KITTI 640x192, under `ppeadepth_tpu.options.Config`'s
# field names and defaults. Spelled out so this script imports nothing of
# the JAX package.
SHIPPED_B = SimpleNamespace(
    adapter=True, rep_size="b", adpt_test=4, ratio=0.25, g_blk=1.0,
    g_ffn=1.0, trans=False, input=False, mono_trans=False, mono_input=False,
    dc=False, dyn_cv=False, num_depth_bins=96, depth_binning="log",
    height=192, width=640, min_depth=0.1, max_depth=100.0)
# ... and the fields the training step reads, at Config's defaults with bf16
# compute (bench.py's train step: no use_checkpoint, batch 12)
TRAIN_B = SimpleNamespace(
    **vars(SHIPPED_B), frame_ids=(0, -1, 1), matching_ids=(0, -1),
    drop_path_rate=0.3, use_checkpoint=False, compute_dtype="bfloat16",
    learning_rate=1e-4, scheduler_step_size=15, disparity_smoothness=1e-3,
    no_ssim=False, disable_automasking=False, disable_motion_masking=False,
    no_matching_augmentation=False, selec_reproj=False, notadabins=False,
    freeze_teacher_and_pose=False, freeze_pose=False, grad_accum=1,
    fullft_reb=False, dec_only=False, lps2=False)


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
    """Kernel A against its plain version (one cuDNN call, which is also
    the library yardstick) at the four stage shapes. Times and bounds are
    per teacher forward (the sum over its 24 calls)."""
    import torch

    from ppeadepth_tpu_torch.kernels.lk_conv import depthwise_plain, lk_depthwise

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
        ms += kk * blocks
        plain_ms += p * blocks
        bound.add(bnd, by, blocks)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound.ms,
                bound_by=bound.by, library_ms=plain_ms)


def check_ffn_fused(dev, rng):
    """Kernel B against its plain version at the four stage shapes, with
    the adapter (the main path) and without it. Times and bounds are per
    teacher forward (the sum over its 24 calls, with the adapter)."""
    import torch

    from ppeadepth_tpu_torch.kernels.ffn_fused import (
        FoldedFFN, ffn_fused, ffn_fused_plain)

    def t(shape, scale, dtype=torch.bfloat16):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype("float32")).to(dev).to(dtype)

    worst, ms, plain_ms, bound = 0.0, 0.0, 0.0, _Bound()
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
        ca = CA if adapter else 0
        flop = 2 * M * C * (2 * H4 + 2 * ca)
        nbytes = (2 * 2 * M * C + 2 * 2 * C * (H4 + ca)
                  + 4 * (H4 + C + (ca + C if adapter else 0)))
        bnd, by = _bound_ms(nbytes, flop, BF16_FLOP_PER_S)
        print(f"{tag}: {kk:.4f} ms/call ({flop / kk / 1e9:.1f} TFLOP/s), "
              f"plain (cuBLAS bf16) {pl:.4f} ms/call, bound {bnd:.4f} ms "
              f"({by}), x{blocks} per forward")
        if adapter:
            ms += kk * blocks
            plain_ms += pl * blocks
            bound.add(bnd, by, blocks)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound.ms,
                bound_by=bound.by, library_ms=None)


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


def check_plane_sweep(dev, rng):
    """Kernel C against its plain version at the student's main-path shape
    (B=8, 48x160, C=128, 96 log bins 0.1-10, 1/4-scale KITTI intrinsics, a
    non-degenerate pose), with f32 and with bf16 features (the main path's
    dtype, timed)."""
    import torch

    from ppeadepth_tpu_torch.kernels.cost_volume import plane_sweep, plane_sweep_plain
    from ppeadepth_tpu_torch.ops.cost_volume import compute_depth_bins, project

    C, H, W, _, _ = _stage_shapes()[0]
    D = SHIPPED_B.num_depth_bins
    K, invK = (torch.from_numpy(a).to(dev) for a in _kitti_K(H, W, BATCH))
    T = torch.from_numpy(_pose_4x4(rng, BATCH)).to(dev)
    P = (K @ T)[:, :3]
    A = (P[:, :, :3] @ invK[:, :3, :3]).contiguous()
    t = P[:, :, 3].contiguous()
    bins = compute_depth_bins(*DEPTH_BINS, D, device=dev)
    x, y = project(A, t, bins, H, W)
    edge = (x >= 2) & (x <= W - 2) & (y >= 2) & (y <= H - 2)
    near = torch.minimum(torch.minimum((x - 2).abs(), (x - (W - 2)).abs()),
                         torch.minimum((y - 2).abs(), (y - (H - 2)).abs())
                         ) < C_NEAR_PX
    gy, gx = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    border = ((gy >= 2) & (gy < H - 2) & (gx >= 2) & (gx < W - 2)).reshape(-1)
    samples = (edge & border).sum().item()
    near = near.reshape(BATCH, D, H, W)

    worst, out = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        def feats():
            return torch.from_numpy(rng.randn(BATCH, H, W, C).astype("float32")
                                    ).to(dev).to(dtype).permute(0, 3, 1, 2)

        cur, lk = feats(), feats()
        got = plane_sweep(cur, lk, A, t, bins)
        torch.cuda.synchronize()
        ref = plane_sweep_plain(cur, lk, A, t, bins)
        diff = (got - ref).abs()
        peak = ref.abs().max().item()
        beyond = diff > C_REL_TOL * peak
        n_beyond = beyond.sum().item()
        n_off = (beyond & ~near).sum().item()
        tag = f"kernel C  [{BATCH},{H},{W},{C}] D={D} {str(dtype)[6:]}"
        print(f"{tag}: max|d|={diff.max().item():.3e} max|ref|={peak:.3e}; "
              f"{n_beyond} of {diff.numel()} entries beyond {C_REL_TOL:g} x "
              f"max|ref| ({n_off} of them off a mask boundary); observed "
              f"samples {samples} of {BATCH * D * H * W}; tol: at most "
              f"{C_BEYOND:g} of the entries beyond, each within {C_NEAR_PX:g} px "
              f"of a mask boundary")
        if n_off or n_beyond > C_BEYOND * diff.numel():
            raise AssertionError(f"kernel C disagrees ({dtype}): {n_beyond} "
                                 f"beyond, {n_off} off a boundary")
        if not (ref > 0).float().mean().item() > 0.1:
            raise AssertionError("kernel C check observed too few samples")
        worst = max(worst, diff.max().item())
        pl, kk = _time_pair(lambda: plane_sweep_plain(cur, lk, A, t, bins),
                            lambda: plane_sweep(cur, lk, A, t, bins), 5)
        # per observed sample: 12 f32 operations a channel (bilinear 9, sub,
        # abs, sum); per (item, bin, pixel): ~12 for the projection
        flop = 12 * C * samples + 12 * BATCH * D * H * W
        nbytes = 2 * BATCH * H * W * C * cur.element_size() + 4 * BATCH * D * H * W
        bnd, by = _bound_ms(nbytes, flop, F32_FLOP_PER_S)
        print(f"{tag}: {kk:.4f} ms/call ({flop / kk / 1e9:.2f} TFLOP/s of "
              f"{flop / 1e9:.2f} GFLOP), plain (torch gather) {pl:.4f} ms/call, "
              f"bound {bnd:.4f} ms ({by}: {nbytes / 1e6:.1f} MB)")
        out = dict(ms=kk, plain_ms=pl, bound_ms=bnd, bound_by=by)
    return dict(max_abs_err=worst, library_ms=None, **out)


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


def check_warp(dev, rng):
    """Kernel D, forward and coordinate gradient, against its plain
    version (torch gathers, autograd for the gradient) at one branch's
    warp of the training step: [24, 192, 640, 3] (2 frames x B=12), f32."""
    import torch
    import torch.nn.functional as F

    from ppeadepth_tpu_torch.kernels.warp import (
        coords_grad, warp_border, warp_border_plain)

    n, height, width = 2 * TRAIN_BATCH, SHIPPED_B.height, SHIPPED_B.width
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
        nbytes = (4 * n * height * width * (2 + 3 + 3) if phase == "forward"
                  else 4 * n * height * width * (2 + 3 + 3 + 2))
        flop = n * height * width * (30 if phase == "forward" else 45)
        bnd, by = _bound_ms(nbytes, flop, F32_FLOP_PER_S)
        print(f"{tag} {phase}: {kk:.4f} ms/call ({nbytes / kk / 1e9:.3f} TB/s of "
              f"{nbytes / 1e6:.1f} MB), plain (torch gathers) {pl:.4f} ms, "
              f"F.grid_sample {lib:.4f} ms, bound {bnd:.4f} ms ({by})")
        results[phase] = dict(ms=kk, plain_ms=pl, library_ms=lib, bound_ms=bnd,
                              bound_by=by)
    results["forward"]["max_abs_err"] = fwd_err
    results["backward"]["max_abs_err"] = bwd_err
    return results


def _train_lk_calls(opt):
    """(C, H, W, k, forward calls, dx calls) of the large-kernel convs in
    one training step: every block's large and small kernel in the teacher
    and in the student's current-frame pass (forward and dx), and the
    student's lookup pass through stage 0 (forward only, no gradient)."""
    from ppeadepth_tpu_torch.models.replknet import REPLK_CONFIGS

    small = REPLK_CONFIGS[opt.rep_size]["small_kernel"]
    calls = []
    for i, (C, H, W, k, blocks) in enumerate(_stage_shapes()):
        lookup = blocks if i == 0 else 0
        for kk in (k, small):  # lkb_origin and small_conv
            calls.append((C, H, W, kk, 2 * blocks + lookup, 2 * blocks))
    return calls


def check_lk_train(dev, rng):
    """Kernel #2, the training large-kernel conv: kernel A without bias
    (forward) and on the flipped kernel (dx, through the autograd
    Function), against its plain version (cuDNN in f32, TF32 off) at each
    conv shape of the training step at B=12, in f32 and bf16. Times and
    bounds are per training step in bf16 (the main path), summed over its
    calls; the library yardstick is cuDNN's depthwise `F.conv2d` forward
    and `torch.nn.grad.conv2d_input`."""
    import torch

    from ppeadepth_tpu_torch.kernels.lk_conv import (
        _input_grad, depthwise_plain, lk_depthwise, lk_depthwise_train)

    worst, step = 0.0, {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    bound, f32 = _Bound(), {"ms": 0.0, "plain_ms": 0.0}
    for C, H, W, k, n_fwd, n_dx in _train_lk_calls(TRAIN_B):
        for dtype in (torch.float32, torch.bfloat16):
            def t(shape, scale):
                return torch.from_numpy((rng.randn(*shape) * scale).astype(
                    "float32")).to(dev).to(dtype)

            x = t((TRAIN_BATCH, H, W, C), 1.0).permute(0, 3, 1, 2)
            g = t((TRAIN_BATCH, H, W, C), 1.0).permute(0, 3, 1, 2)
            w = t((C, 1, k, k), 1.0 / k)
            wf = w.flip(-1, -2).contiguous()
            xg = x.detach().requires_grad_(True)
            y = lk_depthwise_train(xg, w)
            y.backward(g)
            torch.cuda.synchronize()
            tol = A_REL_TOL if dtype == torch.bfloat16 else A_F32_REL_TOL
            tag = f"kernel #2 [{TRAIN_BATCH},{H},{W},{C}] k={k} {str(dtype)[6:]}"
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
            macs = _dw_macs(TRAIN_BATCH, H, W, C, k)
            esize = x.element_size()
            bnd, by = _bound_ms(esize * (2 * TRAIN_BATCH * H * W * C + C * k * k),
                                2 * macs, F32_FLOP_PER_S)
            print(f"{tag}: forward {k_f:.4f} ms (plain/cuDNN {p_f:.4f}), dx "
                  f"{k_d:.4f} ms (plain {p_d:.4f}, conv2d_input {lib_d:.4f}), "
                  f"bound {bnd:.4f} ms ({by}) each; x{n_fwd} forward, x{n_dx} dx "
                  f"per step")
            if dtype == torch.bfloat16:
                step["ms"] += k_f * n_fwd + k_d * n_dx
                step["plain_ms"] += p_f * n_fwd + p_d * n_dx
                step["library_ms"] += p_f * n_fwd + lib_d * n_dx
                bound.add(bnd, by, n_fwd + n_dx)
            else:
                f32["ms"] += k_f * n_fwd + k_d * n_dx
                f32["plain_ms"] += p_f * n_fwd + p_d * n_dx
    print(f"kernel #2 per training step (bf16): {step['ms']:.3f} ms, plain "
          f"{step['plain_ms']:.3f} ms, bound {bound.ms:.3f} ms; in f32 "
          f"{f32['ms']:.3f} ms, plain {f32['plain_ms']:.3f} ms")
    return dict(max_abs_err=worst, bound_ms=bound.ms, bound_by=bound.by,
                f32_ms=f32["ms"], f32_plain_ms=f32["plain_ms"], **step)


def _random_state_dict(opt):
    """Seeded random weights of the whole RepDepth in training form.

    Conv/linear weights come from `init_weights`; adapter `D_fc2` weights
    are drawn from a numpy seed (not zero) so the adapter branches count.
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
    model = RepDepth(SimpleNamespace(**{**vars(opt), "drop_path_rate": 0.0}))
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


def _compare_disp(depth, ref, opt, tag):
    """|d disparity| of the card's bf16 answer against the CPU f32 one."""
    import numpy as np

    def disp(d):
        lo, hi = 1.0 / opt.max_depth, 1.0 / opt.min_depth
        return (1.0 / d - lo) / (hi - lo)

    dd = np.abs(disp(depth) - disp(ref))
    print(f"{tag}: |d disp| vs CPU f32 mean {dd.mean():.3e} max {dd.max():.3e} "
          f"(tol {DISP_MEAN_TOL:g} / {DISP_MAX_TOL:g}); disp range "
          f"[{disp(ref).min():.4f}, {disp(ref).max():.4f}]")
    if not (dd.mean() <= DISP_MEAN_TOL and dd.max() <= DISP_MAX_TOL):
        raise AssertionError(f"{tag}: card forward disagrees with the CPU forward")


def _latency(fn, requests, tag):
    """Median host wall of 10 calls, which return host numpy (so the device
    work is finished)."""
    import numpy as np

    times = []
    for i in range(10):
        t0 = time.perf_counter()
        fn(*requests[i % len(requests)])
        times.append(time.perf_counter() - t0)
    med = float(np.median(times)) * 1e3
    print(f"{tag} B={BATCH} 640x192 bf16: median {med:.3f} ms/batch "
          f"({BATCH / med * 1e3:.2f} images/s), all "
          f"{[round(t * 1e3, 3) for t in times]} ms")
    return med


def serve_teacher(sess, cpu, opt, requests):
    """Answer REQUESTS teacher batches on the card through the kernels;
    check the outputs, the launch counts and agreement with the CPU f32
    forward."""
    import torch

    from ppeadepth_tpu_torch import kernels

    blocks = sum(s[4] for s in _stage_shapes())
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    depths = [sess.predict_depth(img) for img, _ in requests]
    counts = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    _check_counts(counts, {"lk_dwconv": blocks * REQUESTS,
                           "ffn_fused": blocks * REQUESTS, "plane_sweep": 0},
                  f"teacher: {REQUESTS} requests of B={BATCH}")
    _check_depths(depths, opt, "teacher")
    t0 = time.perf_counter()
    ref = cpu.predict_depth(requests[0][0][:1])
    print(f"teacher: CPU f32 forward of one image in {time.perf_counter() - t0:.2f} s")
    _compare_disp(depths[0][:1], ref, opt, "teacher")
    _latency(lambda img, _: sess.predict_depth(img), requests,
             "teacher: predict_depth")
    print(f"teacher: peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    return counts


def serve_student(sess, cpu, opt, requests):
    """Answer REQUESTS student batches (current frame + previous frame) on
    the card; check the outputs, the launch counts (kernel C once, kernels
    A and B on stage 0 twice and stages 1-3 once) and agreement with the
    CPU f32 forward."""
    import torch

    from ppeadepth_tpu_torch import kernels

    blocks = sum(s[4] for s in _stage_shapes()) + _stage_shapes()[0][4]
    K, invK = _kitti_K(opt.height // 4, opt.width // 4, BATCH)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    depths = [sess.predict_depth_multi(img, lk, K, invK) for img, lk in requests]
    counts = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    _check_counts(counts, {"lk_dwconv": blocks * REQUESTS,
                           "ffn_fused": blocks * REQUESTS,
                           "plane_sweep": REQUESTS},
                  f"student: {REQUESTS} requests of B={BATCH}")
    _check_depths(depths, opt, "student")
    img, lk = requests[0]
    t0 = time.perf_counter()
    ref = cpu.predict_depth_multi(img[:1], lk[:1], K[:1], invK[:1])
    print(f"student: CPU f32 forward of one image in {time.perf_counter() - t0:.2f} s")
    _compare_disp(depths[0][:1], ref, opt, "student")
    _latency(lambda img, lk: sess.predict_depth_multi(img, lk, K, invK),
             requests, "student: predict_depth_multi")
    print(f"student: peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
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
    copies of it, as the serving requests; KITTI intrinsics at scales 0 and
    2. numpy arrays, or tensors on `device`."""
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


def train_parity(sd, dev):
    """One f32 training step on `dev` against the same step on the CPU:
    the same weights, batch (B=PARITY_BATCH) and draws (matching
    augmentation from fixed uniforms, drop path off). Compares the loss,
    every metric and the concatenated trainable gradient."""
    import numpy as np
    import torch

    from ppeadepth_tpu_torch.train.step import StepDraws

    opt = SimpleNamespace(**{**vars(TRAIN_B), "compute_dtype": "float32",
                             "drop_path_rate": 0.0})
    batch = _train_batch(np.random.RandomState(SEED + 2), PARITY_BATCH, opt)
    rng = np.random.RandomState(SEED + 3)
    u = np.linspace(0.1, 0.9, PARITY_BATCH).astype("float32")
    noise = [rng.randn(PARITY_BATCH, opt.height, opt.width, 1).astype("float32")
             for _ in range(2)]
    res = {}
    for device in (dev.type, "cpu"):
        model, state, step = _train_setup(sd, opt, device)
        draws = StepDraws(*(torch.from_numpy(a).to(device) for a in (u, *noise)))
        t0 = time.perf_counter()
        _, metrics = step(state, batch, draws)
        grads = torch.cat([p.grad.flatten().float().cpu()
                           for p in model.parameters() if p.requires_grad])
        res[device] = ({k: v.item() for k, v in metrics.items()}, grads)
        print(f"parity: f32 step B={PARITY_BATCH} on {device} in "
              f"{time.perf_counter() - t0:.2f} s (first call)")
        del model, step
    (m_gpu, g_gpu), (m_cpu, g_cpu) = res[dev.type], res["cpu"]
    worst = max(abs(m_gpu[k] - m_cpu[k]) for k in m_cpu if "depth_bins" not in k)
    bins = max(abs(m_gpu[k] / m_cpu[k] - 1) for k in m_cpu if "depth_bins" in k)
    rel = ((g_gpu - g_cpu).norm() / g_cpu.norm()).item()
    print(f"parity: metrics card {m_gpu}")
    print(f"parity: metrics CPU  {m_cpu}")
    print(f"parity: max |d metric| {worst:.3e} (tol {PARITY_METRIC_TOL:g}), depth "
          f"bins rel {bins:.3e} (tol {PARITY_BIN_REL:g}), trainable gradient "
          f"({g_cpu.numel()} entries) relative L2 {rel:.3e} (tol {PARITY_GRAD_L2:g})")
    if not (worst <= PARITY_METRIC_TOL and bins <= PARITY_BIN_REL
            and rel <= PARITY_GRAD_L2 and np.isfinite(rel)):
        raise AssertionError("parity: the card's f32 step disagrees with the CPU's")
    return dict(metric_err=worst, grad_rel_l2=rel)


def _expected_launches(opt):
    """Launches of each kernel in one training step of the configuration:
    kernel D once per branch forward and backward; kernel A forward and dx
    as `_train_lk_calls`; the plane sweep once per lookup frame."""
    calls = _train_lk_calls(opt)
    return {"warp_fwd": 2, "warp_bwd": 2, "ffn_fused": 0,
            "lk_dwconv": sum(c[4] for c in calls),
            "lk_dwconv_dx": sum(c[5] for c in calls),
            "plane_sweep": len(opt.matching_ids) - 1}


def train_steps(sd, dev, profile):
    """The training phase: bf16 compute, B=TRAIN_BATCH, 640x192, on `dev`:
    one warm-up step and TRAIN_STEPS timed ones, with the launch counts,
    invariants and depth-bin EMA checked after each."""
    import numpy as np
    import torch

    from ppeadepth_tpu_torch import kernels
    from ppeadepth_tpu_torch.core.geometry import disp_to_depth

    opt = TRAIN_B
    t0 = time.perf_counter()
    model, state, step = _train_setup(sd, opt, dev.type)
    print(f"train: state built on the card in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    batch = _train_batch(np.random.RandomState(SEED + 4), TRAIN_BATCH, opt, dev)
    torch.cuda.synchronize()
    print(f"train: batch B={TRAIN_BATCH} uploaded in "
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
    for i in range(1 + TRAIN_STEPS):
        old_bins = (state.min_depth_bin.item(), state.max_depth_bin.item())
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        counts = dict(kernels.launch_counts)
        m = {k: v.item() for k, v in metrics.items()}
        print(f"train step {i}{' (warm-up)' if i == 0 else ''}: loss {m['loss']:.6f} "
              f"(mono {m['mono/loss']:.6f}, multi {m['multi/loss']:.6f}, "
              f"consistency {m['multi/consistency']:.6f}), {dt:.3f} ms host wall, "
              f"launches {counts}")
        if counts != expected:
            raise AssertionError(f"train: launches {counts}, expected {expected}")
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"train: non-finite metrics {m}")
        for n in trainable:
            g = named[n].grad
            if not torch.isfinite(g).all():
                raise AssertionError(f"train: non-finite gradient of {n}")
            if g.abs().max() > 0:
                had_grad.add(n)
        _, d = disp_to_depth(depths[-1], opt.min_depth, opt.max_depth)
        dmin = max(opt.min_depth, d.amin(dim=(1, 2, 3)).mean().item() * 0.9)
        dmax = d.amax(dim=(1, 2, 3)).mean().item() * 1.1
        want = (old_bins[0] * 0.99 + dmin * 0.01, old_bins[1] * 0.99 + dmax * 0.01)
        got = (m["depth_bins/min"], m["depth_bins/max"])
        if not np.allclose(got, want, rtol=1e-5):
            raise AssertionError(f"train: depth bins {got}, EMA gives {want}")
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
    print(f"train: {len(trainable)} trainable tensors "
          f"({sum(named[n].numel() for n in trainable)} of "
          f"{sum(p.numel() for p in named.values())} parameters); "
          f"{len(trainable) - len(had_grad)} never had a non-zero gradient "
          f"{sorted(trainable - had_grad)[:8]}; {len(unmoved)} with a gradient "
          f"did not move; {len(frozen_changed)} frozen tensors changed; "
          f"{stats_moved} of {len(stats0)} BN running statistics moved")
    if frozen_changed or unmoved or stats_moved != len(stats0):
        raise AssertionError(f"train: frozen changed {frozen_changed[:5]}, "
                             f"unmoved {unmoved[:5]}, stats moved {stats_moved}")
    print(f"train: depth bins after {1 + TRAIN_STEPS} steps "
          f"[{state.min_depth_bin.item():.6f}, {state.max_depth_bin.item():.6f}]; "
          f"loss over the timed steps {[round(v, 6) for v in losses]}, "
          f"{'fell' if losses[-1] < losses[0] else 'did not fall'}")
    print(f"train step B={TRAIN_BATCH} 640x192 bf16: median {med:.3f} ms/step "
          f"({TRAIN_BATCH / med * 1e3:.2f} images/s), all "
          f"{[round(t, 3) for t in times]} ms; peak device memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB)")
    if profile:
        profile_serving("train_step", lambda: step(state, batch), [()])
    return counts


def _category(name):
    n = name.lower()
    for key, cat in (("lk_dwconv", "kernel A (lk_dwconv; forward and dx)"),
                     ("ffn_", "kernel B (ffn_fused + split epilogue)"),
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


def profile_serving(tag, fn, requests):
    """torch.profiler over 5 calls (batches or training steps): device time
    by kernel category, device busy (union of kernel intervals) and the
    host wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(*requests[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(5):
            fn(*requests[i % len(requests)])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 5
    spans, cats = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        r = e.time_range
        spans.append((r.start, r.end))
        c = cats.setdefault(_category(e.name), [0.0, 0])
        c[0] += (r.end - r.start) / 1e3 / 5
        c[1] += 1
    if not spans:
        raise AssertionError(f"profile {tag}: the trace holds no device time")
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    busy = busy / 1e3 / 5
    total = sum(v[0] for v in cats.values())
    print(f"profile {tag}: per batch, device busy {busy:.3f} ms, host wall "
          f"{wall:.3f} ms under the profiler, idle share {1 - busy / wall:.4f}")
    for cat, (ms, n) in sorted(cats.items(), key=lambda kv: -kv[1][0]):
        print(f"profile {tag}: {cat}: {ms:.3f} ms/batch, {100 * ms / total:.1f} % "
              f"of device time, {n / 5:g} kernels/batch")


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "the port's smoke run needs a CUDA card")
    import numpy as np

    from ppeadepth_tpu_torch.kernels import build
    from ppeadepth_tpu_torch.serve import InferenceSession

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
        if "registers" in line or "Compiling entry" in line:
            print("ptxas:", line.strip())

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED)
    a = check_lk_dwconv(dev, rng)
    b = check_ffn_fused(dev, rng)
    c = check_plane_sweep(dev, rng)
    d = check_warp(dev, rng)
    lk2 = check_lk_train(dev, rng)

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
    profile = "--profile" in sys.argv[1:]
    if profile:
        K, invK = _kitti_K(opt.height // 4, opt.width // 4, BATCH)
        profile_serving("predict_depth_multi",
                        lambda img, lk: sess.predict_depth_multi(img, lk, K, invK),
                        requests)
        profile_serving("predict_depth", lambda img, _: sess.predict_depth(img),
                        requests)
    del sess, cpu
    train_parity(sd, dev)
    by_path["train_step"] = train_steps(sd, dev, profile)

    entries = []
    for kname, src, replaces, res, per, path in (
            ("lk_dwconv", "lk_dwconv.cu", "banded_conv.py:287", a,
             "teacher forward (24 calls)", "predict_depth_multi"),
            ("ffn_fused", "ffn_fused.cu", "ffn_mxu.py:201", b,
             "teacher forward (24 calls)", "predict_depth_multi"),
            ("plane_sweep", "plane_sweep.cu", "cost_volume_mxu.py:149", c,
             "call (one per student request)", "predict_depth_multi"),
            ("warp_fwd", "warp_border.cu", "warp_mxu.py:269", d["forward"],
             "call ([24,192,640,3], one per branch)", "train_step"),
            ("warp_bwd", "warp_border.cu", "warp_mxu.py:269", d["backward"],
             "call ([24,192,640,3], one per branch)", "train_step"),
            ("lk_dwconv_dx", "lk_dwconv.cu", "banded_conv.py:152", lk2,
             "training step, bf16 (100 forward + 96 dx calls of kernel A)",
             "train_step")):
        entries.append({
            "name": kname, "route": "cuda",
            "source": f"ppeadepth_tpu_torch/csrc/{src}",
            "replaces": f"ppeadepth_tpu/kernels/{replaces}",
            "launches": by_path[path][kname], "max_abs_err": res["max_abs_err"],
            "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            "library_ms": res["library_ms"], "times_per": per,
            "launches_by_path": {p: n[kname] for p, n in by_path.items()}})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
