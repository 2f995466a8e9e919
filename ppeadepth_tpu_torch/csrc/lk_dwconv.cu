// Large-kernel depthwise convolution: the merged RepLKNet deploy form, and
// the forward and input gradient of the training form.
//
// Replaces: ppeadepth_tpu/kernels/banded_conv.py `banded_depthwise`
// (Pallas body `_kernel`), the TPU kernel behind every merged
// `large_kernel.lkb_reparam` conv (models/replknet.py ReparamLKConv), and
// `banded_depthwise_train` (:152), whose forward and d/dx (:173-178, the
// same conv on the spatially flipped kernel) run the same Pallas body.
//
//   y[b, h, w, c] = sum_{dy, dx} x[b, h + dy - k/2, w + dx - k/2, c] * w[c, dy, dx]
//                   (+ bias[c])
//
// SAME zero padding, stride 1, any odd k <= 31; NHWC memory (an NCHW tensor
// in torch.channels_last). Two instantiations with the same loop: bf16 in
// and out with bf16 weights, and f32 throughout (the training path's f32
// compute); both accumulate in f32.
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
//   * one block per (image, 8x16 output tile, channel group); lane =
//     channel, so every global load and store is contiguous along C. bf16
//     takes 32 channels per block (a warp per output row), f32 16 (a warp
//     per two output rows) so that its halo and weights still fit;
//   * the block's halo tile ((8+k-1) x (16+k-1) channels, 112 KB in bf16
//     and f32 at k=31) and its k*k weights per channel (62 KB) sit in
//     dynamic shared memory, above the 48 KB static limit, hence the
//     cudaFuncSetAttribute opt-in; the halo arrives as 16-byte vectors when
//     C is a multiple of the vector width;
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
constexpr int TH = 8;     // output rows per block
constexpr int TW = 16;    // output columns per thread

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_f32(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ float from_f32(float v) { return v; }

// T: element type; CG: channels per block (one per lane of a row group)
template <typename T, int CG>
__global__ void __launch_bounds__(TH * CG)
lk_dwconv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const T* __restrict__ bias, T* __restrict__ y,
                 int H, int W, int C, int K, int tiles_w) {
  constexpr int NTHREADS = TH * CG;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte vector
  extern __shared__ __align__(16) unsigned char smem[];
  const int half = K / 2;
  const int HH = TH + K - 1;
  const int WW = TW + K - 1;
  T* xs = reinterpret_cast<T*>(smem);  // [HH][WW][CG]
  T* ws = xs + HH * WW * CG;           // [K*K][CG]

  const int b = blockIdx.z;
  const int c0 = blockIdx.y * CG;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int tid = threadIdx.x;
  const int lane = tid % CG;
  const int r = tid / CG;
  const T zero = from_f32<T>(0.f);

  // Halo rows holding real input; rows outside the image are never read.
  const int row_lo = max(0, half - h0);
  const int row_hi = min(HH - 1, H - 1 - h0 + half);
  const int n_rows = row_hi - row_lo + 1;
  if (C % VEC == 0) {
    // 16-byte vectors: VEC channels of one pixel per thread
    constexpr int VPP = CG / VEC;
    for (int i = tid; i < n_rows * WW * VPP; i += NTHREADS) {
      const int v = i % VPP;
      const int p = i / VPP;
      const int col = p % WW;
      const int row = row_lo + p / WW;
      const int ih = h0 - half + row;
      const int iw = w0 - half + col;
      const int c = c0 + v * VEC;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (iw >= 0 && iw < W && c < C) {
        val = *reinterpret_cast<const uint4*>(
            x + ((size_t)(b * H + ih) * W + iw) * C + c);
      }
      *reinterpret_cast<uint4*>(xs + (row * WW + col) * CG + v * VEC) = val;
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
      T v = zero;
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
    const T* xrow = xs + (r + dy) * WW * CG + lane;
    const T* wrow = ws + dy * K * CG + lane;
    float xr[TW + KMAX - 1];
#pragma unroll
    for (int col = 0; col < TW + KMAX - 1; ++col) {
      xr[col] = col < WW ? to_f32(xrow[col * CG]) : 0.f;
    }
#pragma unroll
    for (int dx = 0; dx < KMAX; ++dx) {
      if (dx >= dx_lo && dx <= dx_hi) {
        const float wv = to_f32(wrow[dx * CG]);
#pragma unroll
        for (int j = 0; j < TW; ++j) acc[j] = fmaf(xr[j + dx], wv, acc[j]);
      }
    }
  }

  const int c = c0 + lane;
  if (c >= C) return;
  const float bv = bias != nullptr ? to_f32(bias[c]) : 0.f;
#pragma unroll
  for (int j = 0; j < TW; ++j) {
    const int ow = w0 + j;
    if (ow < W) {
      y[((size_t)(b * H + oh) * W + ow) * C + c] = from_f32<T>(acc[j] + bv);
    }
  }
}

template <typename T, int CG>
int launch(const void* x, const void* w, const void* bias, void* y, int B,
           int H, int W, int C, int K, void* stream) {
  if (K < 1 || K > KMAX || K % 2 == 0 || B < 1 || H < 1 || W < 1 || C < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const size_t smem =
      (size_t)((TH + K - 1) * (TW + K - 1) * CG + K * K * CG) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      lk_dwconv_kernel<T, CG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles_h * tiles_w, (C + CG - 1) / CG, B);
  lk_dwconv_kernel<T, CG><<<grid, TH * CG, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w, (const T*)bias, (T*)y, H, W, C, K, tiles_w);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: [B, H, W, C] (NHWC memory, 16-byte aligned); w: [C, K, K]; bias:
// [C] or null; all bf16 (`_bf16`) or all f32 (`_f32`). Launches on `stream`
// and returns cudaGetLastError().
extern "C" int ppea_lk_dwconv_bf16(const void* x, const void* w,
                                   const void* bias, void* y, int B, int H,
                                   int W, int C, int K, void* stream) {
  return launch<__nv_bfloat16, 32>(x, w, bias, y, B, H, W, C, K, stream);
}

extern "C" int ppea_lk_dwconv_f32(const void* x, const void* w,
                                  const void* bias, void* y, int B, int H,
                                  int W, int C, int K, void* stream) {
  return launch<float, 16>(x, w, bias, y, B, H, W, C, K, stream);
}
