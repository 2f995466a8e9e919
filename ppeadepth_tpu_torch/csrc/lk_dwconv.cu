// Large-kernel depthwise convolution for the merged RepLKNet deploy form.
//
// Replaces: ppeadepth_tpu/kernels/banded_conv.py `banded_depthwise`
// (Pallas body `_kernel`), the TPU kernel behind every merged
// `large_kernel.lkb_reparam` conv (models/replknet.py ReparamLKConv).
//
//   y[b, h, w, c] = sum_{dy, dx} x[b, h + dy - k/2, w + dx - k/2, c] * w[c, dy, dx]
//                   (+ bias[c])
//
// SAME zero padding, stride 1, any odd k <= 31; NHWC memory (an NCHW tensor
// in torch.channels_last), bf16 in and out, bf16 weights, f32 accumulation.
//
// What bounds it on Hopper: CUDA-core FMAs. Each input value is reused k*k
// times (961 at k=31): at B=8, 640x192 the 24 merged convs hold ~48 G
// multiply-adds before clipping, against ~0.25 GB of activation traffic, so
// the f32 FMA rate (33.5 T multiply-adds/s) and not memory is the limit.
// The TPU form rewrote the conv as banded Toeplitz matmuls only because the
// MXU is the TPU's sole fast unit; on Hopper that spends W/k more FLOPs for
// nothing, so this is a direct conv. Its measured times and rates are in
// PERF.md.
//
// Design:
//   * one block per (image, 8x16 output tile, 32-channel group); lane =
//     channel, warp = output row, so every global load and store is
//     contiguous along C;
//   * the block's halo tile ((8+k-1) x (16+k-1) x 32 bf16, 112 KB at k=31)
//     and its k*k x 32 weights (62 KB) sit in dynamic shared memory, above
//     the 48 KB static limit, hence the cudaFuncSetAttribute opt-in; the
//     halo arrives as 16-byte vectors (8 channels of a pixel) when C % 8 == 0;
//   * per kernel row each thread holds the 16+k-1 input values of its row
//     in registers and runs k x 16 FMAs on them (one shared load per ~10
//     FMAs), so shared-memory bandwidth does not bound the loop;
//   * taps are clipped to the valid input: rows outside the image are never
//     loaded nor multiplied (at stages 2-3 k exceeds H: 27 > 12, 13 > 6),
//     and kernel columns whose whole 16-wide span is padding are skipped.
//
// Where it runs: all four encoder stages. The JAX package gated its banded
// kernel to stages 0-1 (banded_conv.py `stage_backends`) because of the
// TPU's 128-lane tile padding at W <= 40; that limit has no Hopper
// counterpart.
//
// First, simple version: no tensor cores (a depthwise conv has no
// reduction over channels to feed them), no cp.async/TMA pipelining, one
// resident block per SM at k=31. Faster forms are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int KMAX = 31;  // largest supported kernel
constexpr int TH = 8;     // output rows per block, one warp each
constexpr int TW = 16;    // output columns per thread
constexpr int CG = 32;    // channels per block, one per lane
constexpr int NTHREADS = TH * CG;

__global__ void __launch_bounds__(NTHREADS)
lk_dwconv_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 const __nv_bfloat16* __restrict__ bias,
                 __nv_bfloat16* __restrict__ y,
                 int H, int W, int C, int K, int tiles_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int half = K / 2;
  const int HH = TH + K - 1;
  const int WW = TW + K - 1;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [HH][WW][CG]
  __nv_bfloat16* ws = xs + HH * WW * CG;                       // [K*K][CG]

  const int b = blockIdx.z;
  const int c0 = blockIdx.y * CG;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int tid = threadIdx.x;
  const int lane = tid % CG;
  const int r = tid / CG;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // Halo rows holding real input; rows outside the image are never read.
  const int row_lo = max(0, half - h0);
  const int row_hi = min(HH - 1, H - 1 - h0 + half);
  const int n_rows = row_hi - row_lo + 1;
  if (C % 8 == 0) {
    // 16-byte vectors: 8 channels of one pixel per thread
    constexpr int VPP = CG / 8;
    for (int i = tid; i < n_rows * WW * VPP; i += NTHREADS) {
      const int v = i % VPP;
      const int p = i / VPP;
      const int col = p % WW;
      const int row = row_lo + p / WW;
      const int ih = h0 - half + row;
      const int iw = w0 - half + col;
      const int c = c0 + v * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (iw >= 0 && iw < W && c < C) {
        val = *reinterpret_cast<const uint4*>(
            x + ((size_t)(b * H + ih) * W + iw) * C + c);
      }
      *reinterpret_cast<uint4*>(xs + (row * WW + col) * CG + v * 8) = val;
    }
  } else {
    for (int i = tid; i < n_rows * WW * CG; i += NTHREADS) {
      const int cc = i % CG;
      const int p = i / CG;
      const int col = p % WW;
      const int row = row_lo + p / WW;
      const int ih = h0 - half + row;
      const int iw = w0 - half + col;
      const int c = c0 + cc;
      __nv_bfloat16 v = zero;
      if (iw >= 0 && iw < W && c < C) {
        v = x[((size_t)(b * H + ih) * W + iw) * C + c];
      }
      xs[(row * WW + col) * CG + cc] = v;
    }
  }
  for (int i = tid; i < K * K * CG; i += NTHREADS) {
    const int cc = i % CG;
    const int t = i / CG;
    const int c = c0 + cc;
    ws[i] = c < C ? w[(size_t)c * K * K + t] : zero;
  }
  __syncthreads();

  const int oh = h0 + r;
  if (oh >= H) return;

  float acc[TW];
#pragma unroll
  for (int j = 0; j < TW; ++j) acc[j] = 0.f;

  // kernel rows landing inside the image for this output row
  const int dy_lo = max(0, half - oh);
  const int dy_hi = min(K - 1, H - 1 - oh + half);
  // kernel columns touching at least one real input column of the tile
  const int col_lo = max(0, half - w0);
  const int col_hi = min(WW - 1, W - 1 - w0 + half);
  const int dx_lo = max(0, col_lo - (TW - 1));
  const int dx_hi = min(K - 1, col_hi);

  for (int dy = dy_lo; dy <= dy_hi; ++dy) {
    const __nv_bfloat16* xrow = xs + (r + dy) * WW * CG + lane;
    const __nv_bfloat16* wrow = ws + dy * K * CG + lane;
    float xr[TW + KMAX - 1];
#pragma unroll
    for (int col = 0; col < TW + KMAX - 1; ++col) {
      xr[col] = col < WW ? __bfloat162float(xrow[col * CG]) : 0.f;
    }
#pragma unroll
    for (int dx = 0; dx < KMAX; ++dx) {
      if (dx >= dx_lo && dx <= dx_hi) {
        const float wv = __bfloat162float(wrow[dx * CG]);
#pragma unroll
        for (int j = 0; j < TW; ++j) acc[j] = fmaf(xr[j + dx], wv, acc[j]);
      }
    }
  }

  const int c = c0 + lane;
  if (c >= C) return;
  const float bv = bias != nullptr ? __bfloat162float(bias[c]) : 0.f;
#pragma unroll
  for (int j = 0; j < TW; ++j) {
    const int ow = w0 + j;
    if (ow < W) {
      y[((size_t)(b * H + oh) * W + ow) * C + c] = __float2bfloat16(acc[j] + bv);
    }
  }
}

}  // namespace

// x, y: [B, H, W, C] bf16 (NHWC memory, 16-byte aligned); w: [C, K, K]
// bf16; bias: [C] bf16 or null. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int ppea_lk_dwconv_bf16(const void* x, const void* w,
                                   const void* bias, void* y, int B, int H,
                                   int W, int C, int K, void* stream) {
  if (K < 1 || K > KMAX || K % 2 == 0 || B < 1 || H < 1 || W < 1 || C < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const size_t smem =
      (size_t)((TH + K - 1) * (TW + K - 1) * CG + K * K * CG) *
      sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      lk_dwconv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles_h * tiles_w, (C + CG - 1) / CG, B);
  lk_dwconv_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
      (const __nv_bfloat16*)bias, (__nv_bfloat16*)y, H, W, C, K, tiles_w);
  return (int)cudaGetLastError();
}
