// Fused deploy ConvFFN: BN-folded 1x1 matmul pair + channel adapter.
//
// Replaces: ppeadepth_tpu/kernels/ffn_mxu.py `ffn_block_apply` (Pallas
// body `_kernel_ffn`), the TPU kernel behind every ConvFFN of the merged
// RepLKNet (models/replknet.py ConvFFN). Over rows of x [M, C]:
//
//   out = x + gelu(x W1 + b1) W2 + b2 [+ gelu(x A1 + a1) A2 + a2]
//
// with every BN already folded into W*/A*/b*/a* (ffn_mxu.py
// `fold_ffn_params`). bf16 operands, f32 accumulation, bf16 output. GELU is
// the exact erf form, as the lax ConvFFN (replknet.py:204) and the torch
// reference compute it; the TPU kernel used tanh-GELU only because Mosaic
// lowers no erf (ffn_mxu.py:19-23).
//
// What bounds it on Hopper: the shapes are tensor-core bound, ~16*M*C^2
// FLOP per block (4C hidden) plus the C/4 adapter, ~386 GFLOP per B=8
// 640x192 teacher forward over its 24 blocks, while each row of x is read
// and written once. This first version is bound instead by the latency of
// its weight-fragment loads, which every warp issues straight from L2; its
// measured times and rates are in PERF.md.
//
// Design:
//   * one block per 32 rows; the bf16 x tile and an f32 [32, C] output
//     accumulator stay in shared memory for the whole block (at C=1024:
//     66 KB + 132 KB, padded rows against bank conflicts; 206 KB in all
//     with the hidden chunk, under the 227 KB a block may opt into);
//   * the hidden width is walked in chunks of 64: h = gelu(x W1[:, chunk] +
//     b1) is formed in shared memory and at once multiplied into the
//     accumulator with W2[chunk, :], so the 4C intermediate never reaches
//     device memory; the adapter branch (hidden C/4) runs the same loop;
//   * products use nvcuda::wmma bf16 16x16x16 fragments; each warp reads
//     its weight fragments straight from device memory (L2-resident across
//     blocks), so eight warps' loads overlap each other's latency;
//   * a few hundred rows at stages 2-3 make only M/32 blocks (120 and 30 on
//     132 SMs), so there the hidden width is split across blocks as well:
//     each writes its f32 partial [32, C] sum to a workspace and a second,
//     elementwise kernel adds them in a fixed order with the residual and
//     biases (deterministic; the 4C intermediate still never leaves the
//     SM). The wrapper picks the split count from M and the SM count;
//   * ragged M is masked: rows past M load as zero and are not stored.
//
// First, simple version: wmma (mma.sync) instead of wgmma, no TMA, no
// multistage pipeline, weights re-read from L2 by every block, one block
// per SM at C=1024. Faster forms are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BM = 32;        // rows per block
constexpr int HC = 64;        // hidden chunk width
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int XPAD = 8;       // bf16 row padding of the x tile
constexpr int YPAD = 4;       // f32 row padding of the accumulator
constexpr int HPAD = 8;       // bf16 row padding of the hidden chunk
constexpr int LDH = HC + HPAD;
constexpr int MAX_C = 1024;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// ys[BM, C] += gelu(xs @ P1[:, lo:hi] + q1[lo:hi]) @ P2[lo:hi, :] for the
// hidden columns [lo, hi) of a hidden width `hid`.
// P1: [C, hid] row-major, q1: [hid] f32, P2: [hid, C] row-major.
__device__ void ffn_branch(const bf16* xs, int ldx, float* ys, int ldy,
                           bf16* hs, float* stage, const bf16* __restrict__ P1,
                           const float* __restrict__ q1,
                           const bf16* __restrict__ P2, int C, int hid,
                           int lo, int hi, int warp, int lane) {
  for (int n0 = lo; n0 < hi; n0 += HC) {
    const int hc = min(HC, hi - n0);
    const int tn1 = hc / 16;
    // 1) hs = gelu(xs @ P1[:, n0:n0+hc] + q1[n0:n0+hc])  (bf16)
    for (int t = warp; t < (BM / 16) * tn1; t += NWARPS) {
      const int tm = t / tn1;
      const int tn = t % tn1;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k = 0; k < C; k += 16) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, xs + tm * 16 * ldx + k, ldx);
        wmma::load_matrix_sync(b, P1 + (size_t)k * hid + n0 + tn * 16, hid);
        wmma::mma_sync(acc, a, b, acc);
      }
      float* st = stage + warp * 256;
      wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int rr = e / 16;
        const int cc = e % 16;
        const float v = st[e] + q1[n0 + tn * 16 + cc];
        hs[(tm * 16 + rr) * LDH + tn * 16 + cc] = __float2bfloat16(gelu_erf(v));
      }
      __syncwarp();
    }
    __syncthreads();
    // 2) ys += hs @ P2[n0:n0+hc, :]
    const int tn2 = C / 16;
    for (int t = warp; t < (BM / 16) * tn2; t += NWARPS) {
      const int tm = t / tn2;
      const int tn = t % tn2;
      float* yp = ys + tm * 16 * ldy + tn * 16;
      FragC acc;
      wmma::load_matrix_sync(acc, yp, ldy, wmma::mem_row_major);
      for (int k = 0; k < hc; k += 16) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, hs + tm * 16 * LDH + k, LDH);
        wmma::load_matrix_sync(b, P2 + (size_t)(n0 + k) * C + tn * 16, C);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(yp, acc, ldy, wmma::mem_row_major);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NTHREADS)
ffn_fused_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                 const bf16* __restrict__ w1, const float* __restrict__ b1,
                 const bf16* __restrict__ w2, const float* __restrict__ b2,
                 const bf16* __restrict__ a1, const float* __restrict__ ab1,
                 const bf16* __restrict__ a2, const float* __restrict__ ab2,
                 float* __restrict__ part, int M, int C, int H4, int CA,
                 int chunks_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = C + XPAD;
  const int ldy = C + YPAD;
  bf16* xs = reinterpret_cast<bf16*>(smem);                   // [BM][ldx]
  float* ys = reinterpret_cast<float*>(xs + BM * ldx);        // [BM][ldy]
  bf16* hs = reinterpret_cast<bf16*>(ys + BM * ldy);          // [BM][LDH]
  float* stage = reinterpret_cast<float*>(hs + BM * LDH);     // [NWARPS][256]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y;

  for (int i = tid; i < BM * C; i += NTHREADS) {
    const int r = i / C;
    const int c = i % C;
    const int row = row0 + r;
    xs[r * ldx + c] = row < M ? x[(size_t)row * C + c] : __float2bfloat16(0.f);
    ys[r * ldy + c] = 0.f;
  }
  __syncthreads();

  const int lo = split * chunks_per_split * HC;
  const int hi = min(H4, lo + chunks_per_split * HC);
  ffn_branch(xs, ldx, ys, ldy, hs, stage, w1, b1, w2, C, H4, lo, hi, warp,
             lane);
  if (a1 != nullptr && split == 0) {
    ffn_branch(xs, ldx, ys, ldy, hs, stage, a1, ab1, a2, C, CA, 0, CA, warp,
               lane);
  }

  for (int i = tid; i < BM * C; i += NTHREADS) {
    const int r = i / C;
    const int c = i % C;
    const int row = row0 + r;
    if (row >= M) continue;
    if (part != nullptr) {  // partial sum; ffn_epilogue_kernel finishes
      part[((size_t)split * M + row) * C + c] = ys[r * ldy + c];
      continue;
    }
    float v = __bfloat162float(xs[r * ldx + c]) + ys[r * ldy + c] + b2[c];
    if (a1 != nullptr) v += ab2[c];
    out[(size_t)row * C + c] = __float2bfloat16(v);
  }
}

// out = x + sum over splits of part + b2 (+ ab2), summed in split order.
__global__ void ffn_epilogue_kernel(const bf16* __restrict__ x,
                                    const float* __restrict__ part,
                                    const float* __restrict__ b2,
                                    const float* __restrict__ ab2,
                                    bf16* __restrict__ out, int M, int C,
                                    int splits) {
  const size_t n = (size_t)M * C;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = (int)(i % C);
  float v = __bfloat162float(x[i]) + b2[c];
  if (ab2 != nullptr) v += ab2[c];
  for (int s = 0; s < splits; ++s) v += part[s * n + i];
  out[i] = __float2bfloat16(v);
}

}  // namespace

// x, out: [M, C] bf16 rows; w1 [C, H4], w2 [H4, C], a1 [C, CA], a2 [CA, C]
// bf16 row-major; b1 [H4], b2 [C], ab1 [CA], ab2 [C] f32. a1/ab1/a2/ab2 may
// all be null (no adapter). C, H4, CA multiples of 16, C <= 1024; all
// pointers 32-byte aligned. The hidden width runs in `splits` blocks per
// 32 rows, `chunks_per_split` 64-wide chunks each; with splits > 1, `part`
// is an f32 [splits, M, C] workspace and a second kernel adds the partial
// sums. Returns cudaGetLastError().
extern "C" int ppea_ffn_fused_bf16(const void* x, void* out, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, const void* a1,
                                   const void* ab1, const void* a2,
                                   const void* ab2, void* part, int M, int C,
                                   int H4, int CA, int splits,
                                   int chunks_per_split, void* stream) {
  const int chunks = (H4 + HC - 1) / HC;
  if (M < 1 || C < 16 || C > MAX_C || C % 16 || H4 < 16 || H4 % 16 ||
      (a1 != nullptr && (CA < 16 || CA % 16)) || splits < 1 ||
      chunks_per_split < 1 || (splits - 1) * chunks_per_split >= chunks ||
      splits * chunks_per_split < chunks || (splits > 1) != (part != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)BM * (C + XPAD) * sizeof(bf16) +
                      (size_t)BM * (C + YPAD) * sizeof(float) +
                      (size_t)BM * LDH * sizeof(bf16) +
                      (size_t)NWARPS * 256 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + BM - 1) / BM, splits);
  ffn_fused_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (bf16*)out, (const bf16*)w1, (const float*)b1,
      (const bf16*)w2, (const float*)b2, (const bf16*)a1, (const float*)ab1,
      (const bf16*)a2, (const float*)ab2, (float*)part, M, C, H4, CA,
      chunks_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t n = (size_t)M * C;
  ffn_epilogue_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                        (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)part, (const float*)b2,
      (const float*)ab2, (bf16*)out, M, C, splits);
  return (int)cudaGetLastError();
}
