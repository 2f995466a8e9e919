"""Kernel A's banded (tensor-core) instance on the CPU: a plain-PyTorch
emulation of csrc/lk_dwconv.cu `lk_dwconv_kernel_banded` under `lk_plan`'s
launch, block by block and warp task by warp task: the per-channel planes
with their zero columns and zero row, the band tables built from the k taps
(rows overlapping in their zeros, flipped in place for dx), each lane's
2J+1 table words placed in the m16n8k16 A fragment as the kernel places
them, the input chunks at the lanes' ldmatrix row addresses (kernel rows
clipped at the image edge), and the epilogue's output positions. In f32 it
must equal `depthwise_plain`, and every output must be written once.

The CUDA kernel itself is held against `depthwise_plain` on the card
(tests/test_torch_gpu_kernels.py).
"""

import numpy as np
import pytest
import torch

from ppeadepth_tpu_torch.kernels.lk_conv import (
    BAND_CB, BAND_NT, _band_plan, band_geometry, depthwise_plain, lk_plan)
from ppeadepth_tpu_torch.models.replknet import REPLK_CONFIGS

LANES = np.arange(32)
G, Q = LANES // 4, LANES % 4


def _table(w, c0, C, k, flip, off):
    """The block's band tables as the kernel lays them out: row c*k + dy
    at word (c*k + dy) * tstride, each word (w[x], w[x+1]) as two f32
    values, x = e + k//2 - off - 15; zero off the kernel."""
    xmin = k // 2 - off - 15
    tstride = k - xmin
    tlen = 14 + 16 * band_geometry(k)[1]
    wc = np.zeros((BAND_CB, k, k + 2), np.float32)  # taps at 1..k, zeros beside
    n = min(BAND_CB, C - c0)
    wg = w[c0:c0 + n, 0]
    wc[:n, :, 1:k + 1] = wg[:, ::-1, ::-1] if flip else wg
    x = np.arange(tstride) + xmin
    rows_lo = wc[:, :, np.clip(x, -1, k) + 1]      # [CB, k, tstride]
    rows_hi = wc[:, :, np.clip(x + 1, -1, k) + 1]
    size = (BAND_CB * k - 1) * tstride + tlen
    lo, hi = np.zeros(size, np.float32), np.zeros(size, np.float32)
    lo[:BAND_CB * k * tstride] = rows_lo.reshape(-1)
    hi[:BAND_CB * k * tstride] = rows_hi.reshape(-1)
    return lo, hi, tstride


def _band_fragments(lo, hi, tstride, k, j_count):
    """A_j [BAND_CB, k, J, 16, 16] from the lanes' table words: lane (g, q)
    reads words e = 2q - g + 7 + 8m, m = 0..2J, of row (c, dy); registers
    (band[2j+1], band[2j], band[2j+2], band[2j+1]) are A's (row g, cols
    2q..), (row g+8, cols 2q..), (row g, cols 2q+8..), (row g+8, cols
    2q+8..), low half first."""
    rows = np.arange(BAND_CB * k)[:, None, None] * tstride
    words = rows + (2 * Q - G + 7)[None, :, None] + 8 * np.arange(2 * j_count + 1)
    wl, wh = lo[words], hi[words]  # [CB*k, 32, 2J+1]
    A = np.zeros((BAND_CB * k, j_count, 16, 16), np.float32)
    for j in range(j_count):
        for m, r0, c0 in ((2 * j + 1, 0, 0), (2 * j, 8, 0), (2 * j + 2, 0, 8),
                          (2 * j + 1, 8, 8)):
            A[:, j, G + r0, 2 * Q + c0] = wl[:, :, m]
            A[:, j, G + r0, 2 * Q + c0 + 1] = wh[:, :, m]
    return A.reshape(BAND_CB, k, j_count, 16, 16)


def emulate_banded(x, w, b, flip, p):
    """y [B, C, H, W] f32 of the banded kernel under plan `p`, and how
    often each output was written."""
    B, C, H, W = x.shape
    k = w.shape[-1]
    half = k // 2
    off, J = band_geometry(k)
    assert (p.j, p.off) == (J, off)
    nch = p.nt + J - 1
    xn = x.permute(0, 2, 3, 1).numpy()  # NHWC
    wn = w.numpy()
    bn = b.numpy() if b is not None else None
    y = np.zeros((B, H, W, C), np.float32)
    hits = np.zeros((B, H, W, C), int)
    cols = (p.segs * p.nt + J - 1) * 16
    zero_row = p.ni * p.img_stride
    for gx in range(p.grid[0]):
        c0 = gx * BAND_CB
        lo, hi, tstride = _table(wn, c0, C, k, flip, off)
        A = _band_fragments(lo, hi, tstride, k, J)
        for gy in range(p.grid[1]):
            b0 = gy // p.tiles_h * p.ni
            h0 = gy % p.tiles_h * p.th
            r_lo, r_hi = max(0, h0 - half), min(H - 1, h0 + p.th - 1 + half)
            planes = np.full((BAND_CB, p.chan_stride), np.nan, np.float32)
            planes[:, zero_row:zero_row + p.pitch] = 0.0
            nc = min(BAND_CB, C - c0)
            for i in range(min(p.ni, B - b0)):
                for r in range(r_hi - r_lo + 1):
                    v = np.zeros((BAND_CB, cols), np.float32)
                    v[:nc, off:off + W] = xn[b0 + i, r_lo + r, :, c0:c0 + nc].T
                    base = i * p.img_stride + r * p.pitch
                    planes[:, base:base + cols] = v
            y_end = min(H, h0 + p.th)
            for task in range(p.th // p.nr * p.segs):
                rg, seg = divmod(task, p.segs)
                y0 = h0 + rg * p.nr
                ylast = min(y0 + p.nr, y_end) - 1
                if ylast < y0:
                    continue
                dys = range(max(0, half - ylast), min(k - 1, half + H - 1 - y0) + 1)
                n = np.arange(8)
                img, yl = n // p.nr, y0 + n % p.nr
                row_ok = (yl <= ylast) & (b0 + img < B)
                col0 = seg * p.nt * 16
                dy = np.arange(dys.start, dys.stop)[:, None]
                r = yl[None] + dy - half
                ok = row_ok[None] & (r >= 0) & (r < H)
                rowoff = np.where(ok, img * p.img_stride + (r - r_lo) * p.pitch, zero_row)
                # chunk ch's B[kk, n] at dy = plane[rowoff[dy, n] + col0 + 16 ch + kk]
                idx = (rowoff[:, None, None, :] + col0
                       + 16 * np.arange(nch)[None, :, None, None]
                       + np.arange(16)[None, None, :, None])
                Bm = planes[:, idx]  # [CB, dy, nch, 16, 8]
                nd = len(dys)
                acc = np.zeros((BAND_CB, 16, p.nt * 8), np.float32)
                for j in range(J):  # sum over (dy, kk) as one product a channel
                    a = A[:, dys, j].transpose(0, 2, 1, 3).reshape(BAND_CB, 16, nd * 16)
                    bm = Bm[:, :, j:j + p.nt].transpose(0, 1, 3, 2, 4).reshape(
                        BAND_CB, nd * 16, p.nt * 8)
                    acc += a @ bm
                acc = acc.reshape(BAND_CB, 16, p.nt, 8).transpose(0, 2, 1, 3)
                # D[m, n] of tile t: column col0 + 16 t + m of row n
                ox = col0 + 16 * np.arange(p.nt)[:, None, None] + np.arange(16)[None, :, None]
                ox, oy, bb = np.broadcast_arrays(ox, (y0 + n % p.nr)[None, None],
                                                 (b0 + n // p.nr)[None, None])
                keep = (ox < W) & (oy <= ylast) & (bb < B)
                for c in range(min(BAND_CB, C - c0)):
                    v = acc[c][keep] + (bn[c0 + c] if bn is not None else 0.0)
                    y[bb[keep], oy[keep], ox[keep], c0 + c] = v
                    np.add.at(hits, (bb[keep], oy[keep], ox[keep], c0 + c), 1)
    return torch.from_numpy(y).permute(0, 3, 1, 2), hits


def _check(B, C, H, W, k, bias, flip, plan=None):
    g = torch.Generator().manual_seed(B * 1000 + H * 10 + k)
    x = torch.randn(B, C, H, W, generator=g)
    w = torch.randn(C, 1, k, k, generator=g) / k
    b = torch.randn(C, generator=g) if bias else None
    p = plan or lk_plan(B, H, W, C, k, torch.bfloat16)
    y, hits = emulate_banded(x, w, b, flip, p)
    assert (hits == 1).all()
    ref = depthwise_plain(x, w.flip(-1, -2) if flip else w, b)
    torch.testing.assert_close(y, ref, rtol=0, atol=1e-5)


_CFG = REPLK_CONFIGS["b"]
# (H, W, k) of the four encoder stages at 640x192 (KITTI), 512x192
# (CityScapes) and 320x480 (DDAD, whose last stage is 15 wide)
STAGES = [(h // 4 >> i, w // 4 >> i, _CFG["large_kernel_sizes"][i])
          for h, w in ((192, 640), (192, 512), (320, 480)) for i in range(4)]


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("H,W,k", STAGES, ids=lambda v: str(v))
def test_banded_emulation_matches_plain_at_stage_shapes(H, W, k, B):
    """The emulation under `lk_plan`'s launch at every stage shape, B=1
    and 3: C=5 (a ragged channel group), bias at B=3, the dx flip at B=1."""
    _check(B, 5, H, W, k, bias=B == 3, flip=B == 1)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("k", [13, 27, 29, 31])
def test_banded_emulation_every_k(k, flip):
    """Each large k of the configurations, forward and flipped, at 12x40."""
    _check(3, 4, 12, 40, k, bias=not flip, flip=flip)


@pytest.mark.parametrize("nt", BAND_NT)
@pytest.mark.parametrize("ni", [1, 2, 4, 8])
def test_banded_emulation_every_tiling(ni, nt):
    """Every instance (NT tiles) and image grouping (NI images of 8 // NI
    rows), row tiles shorter than the image, at both J (k=13: 2; k=27: 3);
    C=5, a ragged last channel group."""
    for k, th_rows in ((13, 2), (27, 1)):
        p = _band_plan(3, 11, 50, 5, k, ni, 8 // ni * th_rows, nt, 2)
        _check(3, 5, 11, 50, k, bias=True, flip=ni % 2 == 0, plan=p)
