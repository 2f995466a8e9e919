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
// Rounding: the coordinate chain (projection, division, the edge-mask
// compare) is written with __fmul_rn / __fadd_rn / __fdiv_rn in the order
// of the plain version (ops/cost_volume.py `project`,
// `sample_bilinear_zeros`): the edge mask compares the sampled coordinate
// with 2 and W-2, so any other rounding would move which samples fall
// inside. The value path (bilinear weights, the four-corner sum, the
// difference) may contract to FMA; the mean divides by C in IEEE, or
// multiplies by 1/C where C is a power of two (the same result).
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
// neighbouring pixels and bins share through L1. Counted once, the inputs
// are read once (2 x 15.7 MB in bf16 at B=8, 48x160x128) and the output
// written once (23.6 MB), so CUDA-core arithmetic and not device memory
// bounds the work. The corner reads are still ~1 KB a sample (5.4 GB of
// L1 requests a call at B=8), so the samples a block has in flight share
// corners. On the H100 the issue rate sets the pace (every gather pointed
// at one corner keeps 81-90 % of the time): per channel and sample, four
// FMAs, one add and, in bf16, four unpacks of a corner value to f32.
//
// Design: the TPU kernel turned the gather into hat-weight matmuls on the
// MXU because Mosaic has no dynamic gather; Hopper gathers through L1/L2,
// so this is a direct gather.
//   * one warp per output pixel, its lanes in 32/G groups of G; a group
//     takes one sample (bin) at a time, each lane NV 16-byte vectors of
//     its channels (G * NV vectors cover C), so a warp has 32/G samples in
//     flight and a log2(G)-step shuffle reduction serves all of them;
//   * bins in rounds of 32: lane j projects bin d0+j once; step s hands
//     bins s*32/G .. s*32/G + 32/G-1 (neighbours, so at far depths the
//     same corners) to the groups by shuffle; lane j keeps bin d0+j's sum,
//     so a round ends in one coalesced 128-byte store of 32 bins;
//   * a block is a 2 x 2 tile of neighbouring pixels, its warps walking
//     the same rounds of bins, so the tile's shared corners are hit in L1
//     (4-warp blocks beat 8-warp ones on the H100);
//   * the pixel's current features stay in registers across all bins.
// `ppea_plane_sweep_fixed` launches instances that point every gather at
// one corner: a timing diagnostic that splits arithmetic from gather time
// (its output is meaningless); the shipped instances have no such branch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int TH = 2;  // pixels a block: rows, and columns (a warp each)
constexpr int TW = 2;
constexpr int THREADS = TH * TW * 32;
constexpr int MAX_C = 256;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;  // channels of a 16-byte vector
  static __device__ __forceinline__ void load(const float* p, float (&v)[N]) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[N]) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is exact: a shift, a mask
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <typename T, int G, int NV, bool FIXED>
__global__ void __launch_bounds__(THREADS, 4)
plane_sweep_kernel(const T* __restrict__ cur, const T* __restrict__ lk,
                   const float* __restrict__ A, const float* __restrict__ tr,
                   const float* __restrict__ bins, float* __restrict__ out,
                   int H, int W, int C, int D) {
  constexpr int VEC = Vec<T>::N;
  constexpr int NG = 32 / G;  // samples a warp has in flight
  const int lane = threadIdx.x & 31;
  const int grp = lane / G;
  const int lig = lane % G;
  const int warp = threadIdx.x >> 5;
  const int gx = blockIdx.x * TW + warp % TW;
  const int gy = blockIdx.y * TH + warp / TW;
  if (gx >= W || gy >= H) return;  // whole warps only
  const int b = blockIdx.z;
  const int HW = H * W;
  const int p = gy * W + gx;
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

  const int nvec = C / VEC;
  const T* cp = cur + ((size_t)b * HW + p) * C;
  float cv[NV][VEC];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = lig + G * j;
    if (v < nvec) {
      Vec<T>::load(cp + v * VEC, cv[j]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) cv[j][i] = 0.f;
    }
  }
  // the corners are addressed in bytes from the lane's first vector, so a
  // step computes two row pointers and each load adds an immediate
  const char* img = reinterpret_cast<const char*>(lk + (size_t)b * HW * C) + lig * 16;
  const unsigned pix_b = C * (unsigned)sizeof(T);
  const unsigned row_b = W * pix_b;
  const unsigned fixed_b = ((H / 2) * W + W / 2) * pix_b;
  const float xmax = (float)(W - 2);
  const float ymax = (float)(H - 2);
  const bool pow2 = (C & (C - 1)) == 0;
  const float inv_c = 1.f / (float)C;

  for (int d0 = 0; d0 < D; d0 += 32) {
    const int nb = min(32, D - d0);
    float xj = 0.f, yj = 0.f;  // 0 fails the edge mask
    if (lane < nb) {
      const float depth = bins[d0 + lane];
      const float den = __fadd_rn(__fadd_rn(__fmul_rn(bz, depth), t2), 1e-7f);
      xj = __fdiv_rn(__fadd_rn(__fmul_rn(bx, depth), t0), den);
      yj = __fdiv_rn(__fadd_rn(__fmul_rn(by, depth), t1), den);
    }
    float mine = 0.f;
#pragma unroll 2
    for (int s0 = 0; s0 < nb; s0 += NG) {
      const float x = __shfl_sync(FULL, xj, s0 + grp);
      const float y = __shfl_sync(FULL, yj, s0 + grp);
      float acc = 0.f;
      if (x >= 2.f && x <= xmax && y >= 2.f && y <= ymax) {  // group-uniform
        const float x0 = floorf(x);
        const float y0 = floorf(y);
        const float wx = __fsub_rn(x, x0);
        const float wy = __fsub_rn(y, y0);
        const float w00 = (1.f - wx) * (1.f - wy);
        const float w01 = wx * (1.f - wy);
        const float w10 = (1.f - wx) * wy;
        const float w11 = wx * wy;
        const char* r0 = img + (FIXED ? fixed_b : (unsigned)(int)y0 * row_b +
                                                   (unsigned)(int)x0 * pix_b);
        const char* r1 = r0 + row_b;
        float acc2[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          if (lig + G * j < nvec) {
            float t00[VEC], t01[VEC], b00[VEC], b01[VEC];
            Vec<T>::load(reinterpret_cast<const T*>(r0 + 16 * G * j), t00);
            Vec<T>::load(reinterpret_cast<const T*>(r0 + pix_b + 16 * G * j), t01);
            Vec<T>::load(reinterpret_cast<const T*>(r1 + 16 * G * j), b00);
            Vec<T>::load(reinterpret_cast<const T*>(r1 + pix_b + 16 * G * j), b01);
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
              const float d = fmaf(w11, b01[i], fmaf(w10, b00[i],
                              fmaf(w01, t01[i], fmaf(w00, t00[i], -cv[j][i]))));
              acc2[i & 1] += fabsf(d);
            }
          }
        }
        acc = acc2[0] + acc2[1];
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(FULL, acc, off);
      // lane s0 + g keeps the sum of group g (bin d0 + s0 + g)
      const float v = __shfl_sync(FULL, acc, ((lane - s0) & (NG - 1)) * G);
      if (lane >= s0 && lane < s0 + NG) mine = v;
    }
    if (lane < nb) o[d0 + lane] = pow2 ? mine * inv_c : __fdiv_rn(mine, (float)C);
  }
}

template <typename T, int G, bool FIXED>
void launch_g(dim3 grid, cudaStream_t s, int nv, const void* cur,
              const void* lk, const float* A, const float* t,
              const float* bins, float* out, int H, int W, int C, int D) {
  const T* c = (const T*)cur;
  const T* l = (const T*)lk;
  switch (nv) {
    case 1: plane_sweep_kernel<T, G, 1, FIXED><<<grid, THREADS, 0, s>>>(c, l, A, t, bins, out, H, W, C, D); break;
    case 2: plane_sweep_kernel<T, G, 2, FIXED><<<grid, THREADS, 0, s>>>(c, l, A, t, bins, out, H, W, C, D); break;
    case 3: plane_sweep_kernel<T, G, 3, FIXED><<<grid, THREADS, 0, s>>>(c, l, A, t, bins, out, H, W, C, D); break;
    default: plane_sweep_kernel<T, G, 4, FIXED><<<grid, THREADS, 0, s>>>(c, l, A, t, bins, out, H, W, C, D);
  }
}

template <typename T, bool FIXED>
void launch(dim3 grid, cudaStream_t s, int g, int nv, const void* cur,
            const void* lk, const float* A, const float* t, const float* bins,
            float* out, int H, int W, int C, int D) {
  if (g == 4) {
    launch_g<T, 4, FIXED>(grid, s, nv, cur, lk, A, t, bins, out, H, W, C, D);
  } else if (g == 8) {
    launch_g<T, 8, FIXED>(grid, s, nv, cur, lk, A, t, bins, out, H, W, C, D);
  } else {
    launch_g<T, 16, FIXED>(grid, s, nv, cur, lk, A, t, bins, out, H, W, C, D);
  }
}

template <bool FIXED>
int sweep(const void* cur, const void* lk, const void* A, const void* t,
          const void* bins, void* out, int B, int H, int W, int C, int D,
          int bf16, int g, int nv, void* stream) {
  const int vec = bf16 ? 8 : 4;
  if (B < 1 || H < 1 || W < 1 || D < 1 || C < 8 || C % 8 || C > MAX_C ||
      B > 65535 || (long long)H * W * C * (bf16 ? 2 : 4) >= (1ll << 31) ||
      !(g == 4 || g == 8 || g == 16) || nv < 1 || nv > 4 ||
      g * nv * vec < C) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    launch<__nv_bfloat16, FIXED>(grid, s, g, nv, cur, lk, (const float*)A,
                                 (const float*)t, (const float*)bins,
                                 (float*)out, H, W, C, D);
  } else {
    launch<float, FIXED>(grid, s, g, nv, cur, lk, (const float*)A,
                         (const float*)t, (const float*)bins, (float*)out, H,
                         W, C, D);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// cur, lk: [B, H, W, C] (16-byte aligned), bf16 when `bf16` is nonzero,
// else f32; A [B, 3, 3], t [B, 3], bins [D] f32; out [B, H, W, D] f32.
// The launch: groups of g lanes (4, 8 or 16) with nv 16-byte vectors a
// lane (1-4, g * nv vectors covering C), blocks of 2 x 2 pixels. Launches
// on `stream` and returns cudaGetLastError().
extern "C" int ppea_plane_sweep(const void* cur, const void* lk, const void* A,
                                const void* t, const void* bins, void* out,
                                int B, int H, int W, int C, int D, int bf16,
                                int g, int nv, void* stream) {
  return sweep<false>(cur, lk, A, t, bins, out, B, H, W, C, D, bf16, g, nv,
                      stream);
}

// ppea_plane_sweep with every gather pointed at one corner: a timing
// diagnostic (arithmetic and shuffles without the gather's cost); its
// output is meaningless.
extern "C" int ppea_plane_sweep_fixed(const void* cur, const void* lk,
                                      const void* A, const void* t,
                                      const void* bins, void* out, int B,
                                      int H, int W, int C, int D, int bf16,
                                      int g, int nv, void* stream) {
  return sweep<true>(cur, lk, A, t, bins, out, B, H, W, C, D, bf16, g, nv,
                     stream);
}
