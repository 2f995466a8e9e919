"""Depthwise conv (odd k up to 31): BN folding, kernel merging, kernel A and
its launch plan (`lk_plan`: instance, tile and grid per shape).

Kernel A's instance family rests on what the input shows, its dtype and k:
bf16 at k >= 13 (every merged serving conv, training's large-kernel forward
and input gradient) takes the banded instance on the tensor cores, each
kernel row of each channel a banded (Toeplitz) product of 16-column tiles,
`mma.sync` m16n8k16 with f32 accumulators (`band_plans`, `BandPlan`). Its
products are bound by the tensor cores and shared memory's bandwidth about
evenly, its input staging by the loads' latency; the plan weighs both. f32
(the eval, TF32 off, `--lk_backend pallas`) keeps the CUDA-core FMA
instances and every k <= 11 the wide bytes-bound ones (`lk_plans`,
`LKPlan`). The banded plan's row groups take 8 rows of one image for the
tall stages, or the same rows of 2-8 images for the short ones, where every
kernel row of a product then lands inside the image.

Counterparts in the JAX package:
  * `fuse_conv_bn`, `merge_reparam_kernels`: kernels/lk_conv.py:73-107;
  * `depthwise_plain`: kernels/lk_conv.py `_depthwise_lax`;
  * `lk_depthwise` (wrapper of csrc/lk_dwconv.cu): kernels/banded_conv.py
    `banded_depthwise`, the TPU kernel of the merged deploy convs;
  * `lk_depthwise_train`: kernels/banded_conv.py `banded_depthwise_train`
    (:152, custom VJP :169-188), the differentiable training conv: forward
    and d/dx are kernel A (d/dx on the spatially flipped kernel), d/dw is
    torch's conv weight gradient, as JAX takes the lax pullback for it.

Layout: activations are NCHW tensors in torch.channels_last memory (NHWC
bytes), weights torch's depthwise [C, 1, k, k].
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import launch_counts
from .build import check, library

MAX_K = 31

# csrc/lk_dwconv.cu's tiling (keep in step with the source)
TWT = 10              # output columns per thread
# threads per block, wide and narrow instances; __launch_bounds__(that, 2)
# caps a thread's registers at REG_CAP
MAX_THREADS = {True: 512, False: 256}
REG_CAP = {True: 64, False: 128}
WIDE_MAX_K = 11       # k up to this takes the wide (128-byte) channel group
SMS = 132             # H100 SXM
SMEM_PER_SM = 233472  # bytes of shared memory on an SM ...
SMEM_PER_BLOCK = 232448  # ... and the most one block may opt into
SMEM_RESERVED = 1024  # the system's share of each resident block
REGS_PER_SM = 65536
THREADS_PER_SM = 2048


class LKPlan(NamedTuple):
    """One launch of kernel A: tiles of `th` output rows by `tws` strips of
    `twt` columns and `cb` channels, `threads` a block; `nbuf` halo
    buffers of `rows` rows of `pitch` pixels; `smem` bytes of dynamic
    shared memory; `blocks_per_sm` resident (registers counted at their
    REG_CAP); `grid` = (blocks per channel group, groups): each block
    walks tiles blockIdx.x, + blocks, ... of the B * tiles_h * tiles_w."""
    th: int
    tws: int
    twt: int
    cb: int
    threads: int
    rows: int
    pitch: int
    nbuf: int
    smem: int
    tiles_h: int
    tiles_w: int
    groups: int
    grid: tuple
    blocks_per_sm: int


def _make_plan(B, H, W, C, k, esize, th, tws, nbuf=None):
    wide = k <= WIDE_MAX_K
    # wide: 128 bytes of channels, stored as they come; narrow: 8 channels,
    # stored as f32 (bf16 widened once while staged)
    cb, sesize = (128 // esize, esize) if wide else (8, 4)
    tw = TWT * tws
    ww = tw + k - 1
    # the narrow layout's row pitch is 1 mod 4 pixels: the four 32-byte
    # pixels of four rows that a quarter warp reads fall in four bank
    # quarters
    pitch = ww if wide else ww + (1 - ww) % 4
    rows = min(th + k - 1, H)
    # wide: persistent blocks, the next one or two tiles' halos fetched
    # into a ring of buffers; narrow: a block per tile, one buffer
    nbuf = nbuf or (2 if wide else 1)
    smem = (k * k + nbuf * rows * pitch) * cb * sesize
    threads = cb // 2 * th * tws
    tiles_h, tiles_w, groups = -(-H // th), -(-W // tw), -(-C // cb)
    bps = min((SMEM_PER_SM // (smem + SMEM_RESERVED)),
              REGS_PER_SM // (threads * REG_CAP[wide]),
              THREADS_PER_SM // threads, 32)
    n_tiles = B * tiles_h * tiles_w
    blocks = min(n_tiles, -(-SMS * bps // groups)) if wide else n_tiles
    return LKPlan(th, tws, TWT, cb, threads, rows, pitch, nbuf, smem, tiles_h,
                  tiles_w, groups, (blocks, groups), bps)


def _plan_cost(p, B, H, W, k):
    """A model of a plan's time, in units of its ideal (lower is better):
    wave quantisation over the SMs and over a block's tiles; the outputs
    computed in tile padding; the halo staged per output (wide, k <= 11:
    bytes, so at full weight; narrow: against the taps each staged value
    feeds); and, weakly, threads short of the SM's fill. Its weights were
    fitted to `chip_smoke.py --kernel A --sweep` on an H100 (PERF.md);
    `_TUNED` holds the main-path shapes where its pick measured more than
    3 % slower than the best tile."""
    blocks = p.grid[0] * p.grid[1]
    slots = SMS * p.blocks_per_sm
    n_tiles = B * p.tiles_h * p.tiles_w
    wave = (-(-blocks // slots) * slots / blocks
            * -(-n_tiles // p.grid[0]) * p.grid[0] / n_tiles)
    outputs = H * W
    staged = p.tiles_h * p.tiles_w * p.rows * (p.twt * p.tws + k - 1)
    padded = p.tiles_h * p.th * p.tiles_w * p.twt * p.tws
    if k <= WIDE_MAX_K:
        occ = min(1.0, p.threads * p.blocks_per_sm / 1024)
        return wave * padded / outputs * (1 + staged / outputs) / occ ** 0.25
    occ = min(1.0, p.threads * p.blocks_per_sm / 512)
    taps = min(k, H) * min(k, W)
    return wave * (padded / outputs + 16 * staged / outputs / taps) / occ ** 0.25


@functools.lru_cache(maxsize=None)
def lk_plans(B: int, H: int, W: int, C: int, k: int, dtype) -> tuple:
    """Kernel A's launches for x [B, C, H, W] and a k x k kernel of `dtype`
    (torch.bfloat16 or torch.float32), best first by `_plan_cost`: every
    tile of at most MAX_THREADS threads whose shared memory fits, only
    those with two or more resident blocks per SM where there are any."""
    esize = 2 if dtype == torch.bfloat16 else 4
    wide = k <= WIDE_MAX_K
    lanes = (128 // esize if wide else 8) // 2
    cands = [_make_plan(B, H, W, C, k, esize, t, s, n)
             for t in range(1, min(H, 64) + 1)
             for s in range(1, -(-W // TWT) + 1)
             for n in ((2, 3) if wide else (1,))
             if lanes * t * s <= MAX_THREADS[wide]]
    cands = [p for p in cands if p.smem <= SMEM_PER_BLOCK and p.blocks_per_sm >= 1]
    if any(p.blocks_per_sm >= 2 for p in cands):
        cands = [p for p in cands if p.blocks_per_sm >= 2]
    return tuple(sorted(cands, key=lambda p: (_plan_cost(p, B, H, W, k), p.nbuf,
                                              -p.threads)))


# (H, W, C, k, dtype) -> (th, tws, nbuf): tiles measured faster on an
# H100 than the model's pick by more than 3 % (`chip_smoke.py --kernel A
# --sweep`; PERF.md), for any batch
_TUNED = {(96, 320, 128, 3, torch.float32): (2, 4, 3),
          (48, 160, 128, 5, torch.bfloat16): (12, 1, 3),
          (12, 40, 512, 5, torch.float32): (6, 1, 3),
          (6, 20, 1024, 5, torch.bfloat16): (6, 1, 3)}


def lk_fma_plan(B: int, H: int, W: int, C: int, k: int, dtype) -> LKPlan:
    """The CUDA-core (FMA) launch for these shapes: a measured tile from
    `_TUNED`, else the first of `lk_plans`."""
    tuned = _TUNED.get((H, W, C, k, dtype))
    if tuned is not None:
        return _make_plan(B, H, W, C, k, 2 if dtype == torch.bfloat16 else 4, *tuned)
    return lk_plans(B, H, W, C, k, dtype)[0]


# ---- the banded (tensor-core) instances: bf16, k >= BAND_MIN_K ----

BAND_MIN_K = 13
BAND_CB = 4           # channels per block (csrc: BAND_CB)
BAND_TILE = 16        # output columns of one m16n8k16 product
BAND_ROWS = 8         # image rows of one product (NI images x NR rows)
BAND_NT = (1, 2, 3, 4, 5)  # 16-column tiles of a warp's task (instances)
BAND_MAX_WARPS = 8


def band_reg_cap(nt: int) -> int:
    """Registers a thread of the NT instance may hold: its accumulators
    (BAND_CB * nt * 4) set the 256-thread blocks its launch bounds keep
    resident (csrc: band_min_blocks), 4, 3 or 2."""
    return REGS_PER_SM // 256 // (4 if nt <= 2 else 3 if nt == 3 else 2)


class BandPlan(NamedTuple):
    """One launch of kernel A's banded instance: blocks of BAND_CB channels
    (grid x) by `ni` images and `th` output rows (grid y: `img_groups` x
    `tiles_h`); a warp's task is `nr` rows of each of the `ni` images by
    `nt` 16-column tiles of one of `segs` column segments, `j` input
    chunks a tile. Shared memory: per channel a plane of `ni` images x
    `rows` halo rows of `pitch` columns (`off` zero columns left of the
    image), `img_stride` apart, and a zero row, `chan_stride` elements a
    channel; then the band tables, a row of `tlen` words per (channel, dy),
    `tstride` words apart (consecutive rows share their zeros); then the
    block's k*k taps."""
    ni: int
    nr: int
    th: int
    nt: int
    j: int
    off: int
    rows: int
    pitch: int
    img_stride: int
    chan_stride: int
    tlen: int
    tstride: int
    segs: int
    tiles_h: int
    img_groups: int
    groups: int
    warps: int
    smem: int
    grid: tuple
    blocks_per_sm: int


def band_geometry(k: int):
    """(off, j): zero columns left of the image in a channel plane (the
    halo rounded up to 16 bytes) and the 16-column input chunks that hold
    the band of 16 outputs."""
    half = k // 2
    off = (half + 7) & ~7
    return off, (half + off + 31) // 16


def _band_plan(B, H, W, C, k, ni, th, nt, warps):
    nr = BAND_ROWS // ni
    off, j = band_geometry(k)
    tiles_w = -(-W // BAND_TILE)
    segs = -(-tiles_w // nt)
    cols = (segs * nt + j - 1) * BAND_TILE
    # a pitch of an odd number of 16-byte units, and images whose offsets
    # continue the rows' pattern: the eight rows an ldmatrix reads (NR rows
    # of NI images) fall in eight bank quarters
    pitch = 8 * (cols // 8 | 1)
    rows = min(th + k - 1, H)
    s8 = -(-rows * pitch // 8)
    if ni > 1:
        s8 += (nr * (pitch // 8) - s8) % 8
    img_stride = 8 * s8
    chan_stride = ni * img_stride + pitch
    tlen = 14 + 16 * j
    tstride = k + 15 + off - k // 2
    tables = -(-((BAND_CB * k - 1) * tstride + tlen) // 4) * 4  # words, to 16 bytes
    smem = BAND_CB * chan_stride * 2 + tables * 4 + BAND_CB * k * k * 2
    tiles_h, img_groups = -(-H // th), -(-B // ni)
    groups = -(-C // BAND_CB)
    threads = 32 * warps
    bps = min(SMEM_PER_SM // (smem + SMEM_RESERVED),
              REGS_PER_SM // (threads * band_reg_cap(nt)), THREADS_PER_SM // threads, 32)
    return BandPlan(ni, nr, th, nt, j, off, rows, pitch, img_stride, chan_stride,
                    tlen, tstride, segs, tiles_h, img_groups, groups, warps, smem,
                    (groups, img_groups * tiles_h), bps)


def _band_cost(p: BandPlan, B, H, W, k):
    """A model of a banded plan's time in SM clocks, fitted to
    `chip_smoke.py --kernel A --sweep` on an H100 (PERF.md). A task's step
    (one channel, one kernel row) issues nt * j products, ~1.5 clocks each
    on the SM's tensor cores, and reads 2j+1 band words and nt+j-1 input
    chunks, 1 and 2 shared-memory wavefronts each (a clock each); the step
    takes the longer. Steps: the kernel rows each row group's rows reach.
    Per block add its staging (the L2 sectors of its pixels, latency-bound);
    both slower with fewer warps resident (of 32) and the tasks' last round
    short of warps; blocks run in waves of the SM's resident blocks."""
    half = k // 2
    steps = 0
    for t in range(p.tiles_h):
        h0 = t * p.th
        y_end = min(H, h0 + p.th)
        for y0 in range(h0, y_end, p.nr):
            ylast = min(y0 + p.nr, y_end) - 1
            steps += min(k - 1, half + H - 1 - y0) - max(0, half - ylast) + 1
    step = max(1.5 * p.nt * p.j, 2 * p.j + 1 + 2 * (p.nt + p.j - 1))
    tasks = p.th // p.nr * p.segs
    imbalance = (-(-tasks // p.warps) * p.warps / tasks) ** 0.25
    occ = min(1.0, p.warps * p.blocks_per_sm / 32)
    compute = step * BAND_CB * p.segs * steps / p.tiles_h * imbalance / occ ** 0.2
    staged = 8 * p.ni * p.rows * W * 32 / 64 / occ ** 0.5
    blocks = p.grid[0] * p.grid[1]
    slots = SMS * p.blocks_per_sm
    return -(-blocks // slots) * p.blocks_per_sm * (compute + staged)


@functools.lru_cache(maxsize=None)
def band_plans(B: int, H: int, W: int, C: int, k: int) -> tuple:
    """The banded instance's launches for x [B, C, H, W] bf16 and a k x k
    kernel, best first by `_band_cost`: NI images of 1, 2, 4 or 8, for
    each count of row tiles the shortest tile, every NT and 2, 4 or 8
    warps, whose shared memory fits."""
    tiles_w = -(-W // BAND_TILE)
    cands = []
    for ni in (1, 2, 4, 8):
        nr = BAND_ROWS // ni
        # for each count n of row tiles, the shortest tile of whole row groups
        ths = {-(-H // n) for n in range(1, -(-H // nr) + 1)}
        for th in sorted({-(-t // nr) * nr for t in ths}):
            for nt in BAND_NT:
                if nt > tiles_w and nt > 1:
                    continue
                for warps in (2, 4, BAND_MAX_WARPS):
                    p = _band_plan(B, H, W, C, k, ni, th, nt, warps)
                    if p.smem <= SMEM_PER_BLOCK and p.blocks_per_sm >= 1 and p.grid[1] <= 65535:
                        cands.append(p)
    return tuple(sorted(cands, key=lambda p: (_band_cost(p, B, H, W, k), p.ni, -p.th)))


def lk_plan(B: int, H: int, W: int, C: int, k: int, dtype):
    """The launch kernel A takes for these shapes: the banded (tensor-core)
    instance for bf16 and k >= BAND_MIN_K, else the CUDA-core instance of
    `lk_fma_plan`. The choice rests on dtype and k alone. Pure Python: the
    CPU tests check that it covers every output once."""
    if dtype == torch.bfloat16 and k >= BAND_MIN_K:
        return band_plans(B, H, W, C, k)[0]
    return lk_fma_plan(B, H, W, C, k, dtype)


def fuse_conv_bn(kernel, gamma, beta, mean, var, eps: float = 1e-5):
    """Fold eval-mode BN into a bias-free conv: returns (kernel', bias').
    kernel: [O, I, kh, kw] (torch layout). replknet.py:68-77."""
    std = torch.sqrt(var + eps)
    t = gamma / std
    return kernel * t[:, None, None, None], beta - mean * gamma / std


def merge_reparam_kernels(lk_kernel, lk_bn, small_kernel=None, small_bn=None,
                          eps: float = 1e-5):
    """Merge the parallel (large, small) depthwise conv+BN branches into one
    biased large-kernel conv. BNs are dicts with torch's names
    {weight, bias, running_mean, running_var}. replknet.py:110-117."""
    def fold(k, bn):
        return fuse_conv_bn(k, bn["weight"], bn["bias"], bn["running_mean"],
                            bn["running_var"], eps)

    eq_k, eq_b = fold(lk_kernel, lk_bn)
    if small_kernel is not None:
        s_k, s_b = fold(small_kernel, small_bn)
        pad = (lk_kernel.shape[-1] - small_kernel.shape[-1]) // 2
        eq_k = eq_k + F.pad(s_k, (pad, pad, pad, pad))
        eq_b = eq_b + s_b
    return eq_k, eq_b


def depthwise_plain(x, w, b: Optional[torch.Tensor] = None):
    """SAME stride-1 depthwise conv, the plain version of kernel A."""
    return F.conv2d(x, w, b, padding=w.shape[-1] // 2, groups=x.shape[1])


_ENTRY = {torch.bfloat16: "ppea_lk_dwconv_bf16", torch.float32: "ppea_lk_dwconv_f32"}
_CL = torch.channels_last


def _validate(x, w, b):
    """Raise on inputs kernel A does not take. Reads each tensor attribute
    once: host time is a cost of the small convs."""
    if x.dim() != 4:
        raise ValueError(f"lk_depthwise: x must be [B, C, H, W], got {tuple(x.shape)}")
    C = x.shape[1]
    wshape = w.shape
    k = wshape[-1] if len(wshape) == 4 else -1
    if wshape != (C, 1, k, k) or not k & 1 or not 1 <= k <= MAX_K:
        raise ValueError(f"lk_depthwise: w must be [C={C}, 1, k, k] with odd "
                         f"k <= {MAX_K}, got {tuple(wshape)}")
    dtype, device = x.dtype, x.device
    if dtype not in _ENTRY or w.dtype != dtype:
        raise TypeError(f"lk_depthwise: x is {dtype}, w {w.dtype}; expected "
                        f"one of {tuple(_ENTRY)}, both the same")
    if w.device != device:
        raise ValueError(f"lk_depthwise: w on {w.device}, x on {device}")
    if b is not None:
        if b.shape != (C,):
            raise ValueError(f"lk_depthwise: bias must be [{C}], got {tuple(b.shape)}")
        if b.dtype != dtype:
            raise TypeError(f"lk_depthwise: bias is {b.dtype}, x {dtype}")
        if b.device != device:
            raise ValueError(f"lk_depthwise: bias on {b.device}, x on {device}")
        if not b.is_contiguous():
            raise ValueError("lk_depthwise: bias must be contiguous")
    if not x.is_contiguous(memory_format=_CL):
        raise ValueError("lk_depthwise: x must be channels_last contiguous")
    if not w.is_contiguous():
        raise ValueError("lk_depthwise: w must be contiguous")


_BAND_ENTRY = "ppea_lk_dwconv_banded_bf16"


def _args(B, H, W, C, k, flip, p, dtype):
    """(C entry, its int arguments as the entry reads them) of plan `p`."""
    if isinstance(p, BandPlan):
        return _BAND_ENTRY, (ctypes.c_int * 20)(
            B, H, W, C, k, int(flip), p.ni, p.nr, p.th, p.pitch, p.img_stride,
            p.chan_stride, p.tlen, p.segs, p.tiles_h, p.warps, p.smem,
            p.img_groups, p.nt, p.j)
    return _ENTRY[dtype], (ctypes.c_int * 14)(
        B, H, W, C, k, int(flip), p.th, p.tws, p.cb, p.rows, p.pitch, p.smem,
        p.grid[0], p.nbuf)


@functools.lru_cache(maxsize=None)
def lk_launch_args(B, H, W, C, k, dtype, flip):
    """`_args` under `lk_plan`, built once per shape."""
    return _args(B, H, W, C, k, flip, lk_plan(B, H, W, C, k, dtype), dtype)


_fns: dict = {}  # C entry name -> the library's function


def _launch(x, w, b, counter: str, flip: bool = False, plan=None):
    """Kernel A on validated CUDA tensors (on `w` flipped in both spatial
    axes if `flip`), with `lk_plan`'s launch unless `plan` is given;
    counts the launch under `counter`, and a banded one under
    `lk_dwconv_banded` too."""
    B, C, H, W = x.shape
    k = w.shape[-1]
    dtype = x.dtype
    x_ptr = x.data_ptr()
    if x_ptr % 16:
        raise ValueError("lk_depthwise: x must be 16-byte aligned")
    entry, args = (lk_launch_args(B, H, W, C, k, dtype, flip) if plan is None
                   else _args(B, H, W, C, k, flip, plan, dtype))
    y = torch.empty_like(x)  # channels_last, as x is
    fn = _fns.get(entry)
    if fn is None:
        fn = _fns[entry] = getattr(library(), entry)
    # the current stream's handle without building a torch.cuda.Stream
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    err = fn(x_ptr, w.data_ptr(), b.data_ptr() if b is not None else None,
             y.data_ptr(), args, stream)
    check(err, entry)
    launch_counts[counter] += 1
    if entry == _BAND_ENTRY:
        launch_counts["lk_dwconv_banded"] += 1
    return y


def lk_depthwise(x, w, b: Optional[torch.Tensor] = None):
    """SAME stride-1 depthwise conv `x * w (+ b)`.

    x: [B, C, H, W] channels_last; w: [C, 1, k, k] (odd k <= 31); b: [C] or
    None; all bf16 or all f32. CPU tensors take `depthwise_plain`; CUDA
    tensors launch csrc/lk_dwconv.cu."""
    _validate(x, w, b)
    if not x.is_cuda:
        return depthwise_plain(x, w, b)
    return _launch(x, w, b, "lk_dwconv")


def _input_grad(g, w):
    """d/dx of the SAME conv: the same conv of the output gradient with the
    spatially flipped kernel (banded_conv.py:173-178), which kernel A reads
    in place. Autograd's gradient need not be channels_last: the copy to it
    is part of this step."""
    g = g.contiguous(memory_format=torch.channels_last)
    _validate(g, w, None)
    if not g.is_cuda:
        return depthwise_plain(g, w.flip(-1, -2))
    return _launch(g, w, None, "lk_dwconv_dx", flip=True)


class _LKDepthwiseTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, w)
        return lk_depthwise(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = _input_grad(g, w) if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:
            k = w.shape[-1]
            dw = torch.nn.grad.conv2d_weight(x, w.shape, g, padding=k // 2,
                                             groups=x.shape[1])
        return dx, dw


def lk_depthwise_train(x, w):
    """Differentiable SAME stride-1 depthwise conv without bias (the
    training form's large and small kernels). Forward: `lk_depthwise`;
    d/dx: kernel A on the flipped kernel (`lk_dwconv_dx` launches on a
    card, `depthwise_plain` on the CPU); d/dw only when `w` requires grad,
    by torch's conv weight gradient. Inputs as `lk_depthwise`."""
    return _LKDepthwiseTrain.apply(x, w)
