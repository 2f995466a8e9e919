// Plane-sweep L1 diff volume of one lookup frame for the student's cost
// volume (kernel C).
//
// Replaces: ppeadepth_tpu/kernels/cost_volume_mxu.py `frame_diffs_batch`
// (Pallas body `_kernel`), and computes what its exact f32 reference
// ppeadepth_tpu/ops/cost_volume.py `_frame_diffs` computes. For item b,
// depth bin d and pixel (gx, gy):
//
//   cam    = (A[b] @ (gx, gy, 1)) * bins[d] + t[b]
//   x, y   = cam0 / (cam2 + 1e-7), cam1 / (cam2 + 1e-7)
//   out    = mean_c |bilinear_zeros(lk[b], x, y)[c] - cur[b, gy, gx, c]|
//            * [2 <= x <= W-2 && 2 <= y <= H-2]          (edge mask)
//            * [2 <= gy < H-2 && 2 <= gx < W-2]          (current border)
//
// Inputs cur, lk: [B, H, W, C] (NHWC bytes), f32 or bf16, read as f32
// (bf16 -> f32 is exact, so a bf16 read gives the f32 path's result on the
// same values at half the bytes); A [B, 3, 3], t [B, 3], bins [D] f32.
// Output [B, H, W, D] f32: D innermost, the layout the student's channel
// concat wants. C a multiple of 8, at most 256.
//
// Rounding: the coordinate chain is written with __fmul_rn / __fadd_rn /
// __fdiv_rn, so no multiply-add is contracted and the division is IEEE;
// the order is the one of the plain version (ops/cost_volume.py
// `project`, `sample_bilinear_zeros`). The edge mask compares the sampled
// coordinate with 2 and W-2, so any extra rounding would move which
// samples fall inside.
//
// Masks: where the edge mask holds, x lies in [2, W-2] and y in [2, H-2],
// so all four bilinear corners lie inside the image and the per-corner
// validity of the zeros padding is 1; where it fails the output is 0. So
// the kernel selects instead of multiplying by masks, loads nothing for
// masked samples, and never converts a non-finite coordinate to an int
// (a NaN coordinate gives 0 here, NaN in the JAX path).
//
// What bounds it on Hopper: per observed (item, bin, pixel) sample, ~12 f32
// operations per channel against 4 bilinear corner reads of C values that
// neighbouring pixels share through L1. Counted once, the inputs are read
// once (2 x 15.7 MB in bf16 at B=8, 48x160x128) and the output written
// once (23.6 MB), so CUDA-core arithmetic and not device memory bounds
// the work (PERF.md gives the numbers).
//
// Design (first, simple version): the TPU kernel turned the gather into
// hat-weight matmuls on the MXU because Mosaic has no dynamic gather;
// Hopper gathers through L1/L2, so this is a direct gather.
//   * one warp per output pixel, lanes across C in 4-channel groups (one
//     or two 16-byte f32 / 8-byte bf16 vectors a lane); the pixel's
//     current features stay in registers across all D bins;
//   * bins in rounds of 32: lane j projects bin d0+j once, then each bin's
//     (x, y) is broadcast by shuffle; the channel sum is a shuffle
//     reduction, and lane j keeps bin d0+j's result, so a round ends in one
//     coalesced 128-byte store of 32 bins.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int WARPS = 8;       // pixels per block, one warp each
constexpr int MAX_C = 256;
constexpr int GROUPS = MAX_C / 4 / 32;  // 4-channel groups per lane
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// bilinear value of one channel, all four corners inside the image
__device__ __forceinline__ float lerp2(float t00, float t01, float b00,
                                       float b01, float wx, float wy) {
  const float ux = __fsub_rn(1.f, wx);
  const float uy = __fsub_rn(1.f, wy);
  const float top = __fadd_rn(__fmul_rn(t00, ux), __fmul_rn(t01, wx));
  const float bot = __fadd_rn(__fmul_rn(b00, ux), __fmul_rn(b01, wx));
  return __fadd_rn(__fmul_rn(top, uy), __fmul_rn(bot, wy));
}

__device__ __forceinline__ float absdiff4(float4 t00, float4 t01, float4 b00,
                                          float4 b01, float4 c, float wx,
                                          float wy) {
  float s = fabsf(__fsub_rn(lerp2(t00.x, t01.x, b00.x, b01.x, wx, wy), c.x));
  s += fabsf(__fsub_rn(lerp2(t00.y, t01.y, b00.y, b01.y, wx, wy), c.y));
  s += fabsf(__fsub_rn(lerp2(t00.z, t01.z, b00.z, b01.z, wx, wy), c.z));
  s += fabsf(__fsub_rn(lerp2(t00.w, t01.w, b00.w, b01.w, wx, wy), c.w));
  return s;
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
plane_sweep_kernel(const T* __restrict__ cur, const T* __restrict__ lk,
                   const float* __restrict__ A, const float* __restrict__ tr,
                   const float* __restrict__ bins, float* __restrict__ out,
                   int H, int W, int C, int D) {
  const int lane = threadIdx.x & 31;
  const int HW = H * W;
  const int b = blockIdx.y;
  const int p = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (p >= HW) return;  // whole warps only: p is warp-uniform
  const int gy = p / W;
  const int gx = p - gy * W;
  float* o = out + ((size_t)b * HW + p) * D;
  if (!(gy >= 2 && gy < H - 2 && gx >= 2 && gx < W - 2)) {
    for (int d = lane; d < D; d += 32) o[d] = 0.f;
    return;
  }

  const float* a = A + b * 9;
  const float fx = (float)gx;
  const float fy = (float)gy;
  const float bx = __fadd_rn(__fadd_rn(__fmul_rn(a[0], fx), __fmul_rn(a[1], fy)), a[2]);
  const float by = __fadd_rn(__fadd_rn(__fmul_rn(a[3], fx), __fmul_rn(a[4], fy)), a[5]);
  const float bz = __fadd_rn(__fadd_rn(__fmul_rn(a[6], fx), __fmul_rn(a[7], fy)), a[8]);
  const float t0 = tr[b * 3 + 0];
  const float t1 = tr[b * 3 + 1];
  const float t2 = tr[b * 3 + 2];

  const int groups = C / 4;
  const T* cp = cur + ((size_t)b * HW + p) * C;
  float4 cv[GROUPS];
#pragma unroll
  for (int i = 0; i < GROUPS; ++i) {
    const int g = lane + 32 * i;
    cv[i] = g < groups ? load4(cp + 4 * g) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const T* img = lk + (size_t)b * HW * C;
  const size_t row = (size_t)W * C;
  const float xmax = (float)(W - 2);
  const float ymax = (float)(H - 2);

  for (int d0 = 0; d0 < D; d0 += 32) {
    const int nb = min(32, D - d0);
    float xj = 0.f, yj = 0.f;
    if (lane < nb) {
      const float depth = bins[d0 + lane];
      const float den = __fadd_rn(__fadd_rn(__fmul_rn(bz, depth), t2), 1e-7f);
      xj = __fdiv_rn(__fadd_rn(__fmul_rn(bx, depth), t0), den);
      yj = __fdiv_rn(__fadd_rn(__fmul_rn(by, depth), t1), den);
    }
    float mine = 0.f;
#pragma unroll 4
    for (int j = 0; j < nb; ++j) {
      const float x = __shfl_sync(FULL, xj, j);
      const float y = __shfl_sync(FULL, yj, j);
      float v = 0.f;
      if (x >= 2.f && x <= xmax && y >= 2.f && y <= ymax) {  // warp-uniform
        const float x0 = floorf(x);
        const float y0 = floorf(y);
        const float wx = __fsub_rn(x, x0);
        const float wy = __fsub_rn(y, y0);
        const T* r0 = img + (size_t)(int)y0 * row + (size_t)(int)x0 * C;
        const T* r1 = r0 + row;
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < GROUPS; ++i) {
          const int g = lane + 32 * i;
          if (g < groups) {
            const int c = 4 * g;
            s += absdiff4(load4(r0 + c), load4(r0 + C + c), load4(r1 + c),
                          load4(r1 + C + c), cv[i], wx, wy);
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
        v = __fdiv_rn(s, (float)C);
      }
      if (lane == j) mine = v;
    }
    if (lane < nb) o[d0 + lane] = mine;
  }
}

}  // namespace

// cur, lk: [B, H, W, C] (16-byte aligned), bf16 when `bf16` is nonzero,
// else f32; A [B, 3, 3], t [B, 3], bins [D] f32; out [B, H, W, D] f32.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int ppea_plane_sweep(const void* cur, const void* lk, const void* A,
                                const void* t, const void* bins, void* out,
                                int B, int H, int W, int C, int D, int bf16,
                                void* stream) {
  if (B < 1 || H < 1 || W < 1 || D < 1 || C < 8 || C % 8 || C > MAX_C ||
      B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((H * W + WARPS - 1) / WARPS, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    plane_sweep_kernel<__nv_bfloat16><<<grid, WARPS * 32, 0, s>>>(
        (const __nv_bfloat16*)cur, (const __nv_bfloat16*)lk, (const float*)A,
        (const float*)t, (const float*)bins, (float*)out, H, W, C, D);
  } else {
    plane_sweep_kernel<float><<<grid, WARPS * 32, 0, s>>>(
        (const float*)cur, (const float*)lk, (const float*)A, (const float*)t,
        (const float*)bins, (float*)out, H, W, C, D);
  }
  return (int)cudaGetLastError();
}
