// Kernel B: the deploy ConvFFN as two launches of one tensor-core GEMM.
//
// Replaces: ppeadepth_tpu/kernels/ffn_mxu.py `ffn_block_apply` (Pallas
// body `_kernel_ffn`), the TPU kernel behind every ConvFFN of the merged
// RepLKNet (models/replknet.py ConvFFN). Over rows of x [M, C]:
//
//   out = x + gelu(x W1 + b1) W2 + b2 + gelu(x A1 + a1) A2 + a2
//
// with every BN already folded into W*/A*/b*/a* (kernels/ffn_fused.py
// `fold_ffn_params`). The two branches have one form, so `pack_ffn` folds
// the adapter into the main products once, when a session is built:
// W_up = [W1 | A1], b_up = [b1 | a1], W_down = [W2 ; A2], b_down = b2 + a2,
// one FFN of hidden width Hp = 4C + C/4, zero-padded to a multiple of 64
// (gelu(0) = 0 and the padded rows of W_down are zero). Both weights are
// stored K-major ([N, K], a row per output column). Two launches of the
// GEMM below compute
//
//   up:   H   = gelu_erf(x W_up + b_up)      bf16 [M, Hp] (device memory)
//   down: out = x + H W_down + b_down        bf16 [M, C]
//
// bf16 operands, f32 accumulation, a bf16 hidden, bf16 output. GELU is the
// exact erf form, as the lax ConvFFN (replknet.py:204) and the torch
// reference compute it; the TPU kernel used tanh-GELU only because Mosaic
// lowers no erf (ffn_mxu.py:19-23).
//
// What bounds it on Hopper: operations. ~4.25 * 4 * M * C^2 FLOP per call,
// ~386 GFLOP per B=8 640x192 teacher forward over its 24 blocks, a bound of
// 0.415 ms at the 989 TFLOP/s bf16 tensor-core peak; the bytes (x, out and
// the weights once) take a tenth of that. The hidden's round trip through
// device memory (~1.0 GB per teacher forward, much of it L2-resident at
// stages 2-3) costs ~0.3 ms at 3.35 TB/s, well under the products' time,
// and buys any C that is a multiple of 64 with no split of the hidden.
//
// This is step 2 of the design: wgmma (sm_90a) fed by TMA.
//   * output tiles of BM x BN, BM = 64 per consumer warpgroup (1 or 2),
//     BN 64 or 128, picked per shape by the wrapper (`kernels/ffn_fused.py
//     gemm_plan`) so a launch has about 132 blocks or more: the stage-2/3
//     down products (few rows x C columns) take the smaller tiles;
//   * K walks in tiles of 64 (128 bytes a row) through a ring of STAGES
//     shared-memory buffers of both operands in opted-in dynamic shared
//     memory; one producer warp keeps the ring full with TMA tile loads
//     (128-byte swizzle, rows past M zero-filled), each stage guarded by a
//     full and an empty mbarrier; tensor maps come from libcuda's
//     cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so the
//     library links nothing new;
//   * each consumer warpgroup multiplies its 64 rows with
//     wgmma.m64nBNk16 straight from the swizzled ring, f32 sums in
//     registers, and releases the stage;
//   * the epilogue adds the bias in registers and applies erf-GELU (up) or
//     adds the residual x (down), rounds to bf16 and stores pairs; rows past
//     M are not stored.
// Not yet: a persistent grid, TMA stores, register rebalancing
// (setmaxnreg), more than one wgmma batch in flight.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;  // K per ring stage: 128 bytes of a row
constexpr int STAGES = 4;
constexpr int MAX_C = 2048;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// TMA: the box at (inner k0, outer row0) of `map` into shared `dst`,
// completing `bytes` on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int k0, int row0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k0), "r"(row0)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle (what TMA wrote): start >> 4, leading offset 16 B
// (unused), stride 1024 B between 8-row groups, layout B128
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d[32] (+)= A (64x16, smem desc) * B (64x16 K-major, smem desc)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, 1, 1, 1, 0, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

// d[64] (+)= A (64x16, smem desc) * B (128x16 K-major, smem desc)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, 1, 1, 1, 0, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 128) {
    wgmma_m64n128k16(d, da, db);
  } else {
    wgmma_m64n64k16(d, da, db);
  }
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// One (64 * NC) x BN tile of out = epilogue(A[M, K] * Bt[N, K]^T + bias),
// A and Bt row-major (K contiguous) behind the tensor maps tmA (box
// 64 x BM) and tmB (box 64 x BN). UP: out = gelu(.); else out = . + res
// (res [M, N]). K a multiple of BK, N a multiple of BN, M any. Threads:
// NC consumer warpgroups, then one producer warp.
template <int BN, int NC, bool UP>
__global__ void __launch_bounds__(NC * 128 + 32)
ffn_gemm_kernel(const __grid_constant__ CUtensorMap tmA,
                const __grid_constant__ CUtensorMap tmB,
                const float* __restrict__ bias, const bf16* __restrict__ res,
                bf16* __restrict__ out, int M, int N, int K) {
  constexpr int BM = 64 * NC;
  constexpr int A_BYTES = BM * BK * 2;
  constexpr int STAGE_BYTES = (BM + BN) * BK * 2;

  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle needs 1024-byte aligned tiles
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t full = ring + STAGES * STAGE_BYTES;  // STAGES x 8 bytes
  const uint32_t empty = full + STAGES * 8;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int KT = K / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NC * 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NC * 128) {  // the producer warp
    if (tid == NC * 128) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        // round kt / STAGES: wait for the consumers' release of the
        // previous round (the first round passes at once)
        mbar_wait(empty + 8 * s, ((kt / STAGES) & 1) ^ 1);
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, STAGE_BYTES);
        const uint32_t sa = ring + s * STAGE_BYTES;
        tma_load_2d(sa, &tmA, bar, kt * BK, m0);
        tma_load_2d(sa + A_BYTES, &tmB, bar, kt * BK, n0);
      }
    }
    return;
  }

  const int wg = tid / 128;  // consumer warpgroup: rows wg*64 .. +64
  const int t = tid % 128;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full + 8 * s, (kt / STAGES) & 1);
    const uint32_t sa = ring + s * STAGE_BYTES + wg * 64 * BK * 2;
    const uint32_t sb = ring + s * STAGE_BYTES + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // +32 bytes per k16 step inside the swizzled 128-byte rows
      wgmma_tile<BN>(acc, smem_desc(sa + kk * 32), smem_desc(sb + kk * 32));
    }
    wgmma_commit();
    wgmma_wait0();
    if (t % 32 == 0) mbar_arrive(empty + 8 * s);
  }

  // accumulator layout of wgmma m64nN: warp w of the warpgroup holds rows
  // w*16 + lane/4 (+8); per n8 block j, columns j*8 + (lane%4)*2 (+1)
  const int warp = t / 32;
  const int lane = t % 32;
  const int row_lo = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + (lane % 4) * 2;
    const float2 bv = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_lo + h * 8;
      if (row >= M) continue;
      float v0 = acc[4 * j + 2 * h] + bv.x;
      float v1 = acc[4 * j + 2 * h + 1] + bv.y;
      const size_t off = (size_t)row * N + col;
      if (UP) {
        v0 = gelu_erf(v0);
        v1 = gelu_erf(v1);
      } else {
        const float2 r = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(res + off));
        v0 += r.x;
        v1 += r.y;
      }
      *reinterpret_cast<__nv_bfloat162*>(out + off) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// tensor map of a row-major bf16 [rows, cols] matrix, boxes of
// BK x box_rows, 128-byte swizzle, rows past the end read as zero
int make_map(CUtensorMap* map, const void* base, int rows, int cols,
             int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BN, int NC, bool UP>
int launch_gemm(const bf16* A, const bf16* Bt, const float* bias,
                const bf16* res, bf16* out, int M, int N, int K,
                cudaStream_t stream) {
  constexpr int BM = 64 * NC;
  CUtensorMap tmA, tmB;
  int err = make_map(&tmA, A, M, K, BM);
  if (err == 0) err = make_map(&tmB, Bt, N, K, BN);
  if (err != 0) return err;
  auto kernel = ffn_gemm_kernel<BN, NC, UP>;
  const int smem = STAGES * (BM + BN) * BK * 2 + 2 * STAGES * 8 + 1024;
  static bool opted_in = false;  // the shared-memory opt-in, once
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  kernel<<<grid, NC * 128 + 32, smem, stream>>>(tmA, tmB, bias, res, out, M,
                                                N, K);
  return (int)cudaGetLastError();
}

// The tiles the wrapper may pick, by index (kernels/ffn_fused.py TILES):
// (BM, BN) = (128, 128), (128, 64), (64, 128), (64, 64).
template <bool UP>
int launch_tile(int tile, const bf16* A, const bf16* Bt, const float* bias,
                const bf16* res, bf16* out, int M, int N, int K,
                cudaStream_t s) {
  switch (tile) {
    case 0: return launch_gemm<128, 2, UP>(A, Bt, bias, res, out, M, N, K, s);
    case 1: return launch_gemm<64, 2, UP>(A, Bt, bias, res, out, M, N, K, s);
    case 2: return launch_gemm<128, 1, UP>(A, Bt, bias, res, out, M, N, K, s);
    case 3: return launch_gemm<64, 1, UP>(A, Bt, bias, res, out, M, N, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

constexpr int TILE_N[4] = {128, 64, 128, 64};

}  // namespace

// x, out: [M, C] bf16 rows; w_up [Hp, C] and w_down [C, Hp] bf16 K-major
// (a row per output column); b_up [Hp], b_down [C] f32; hidden: a bf16
// [M, Hp] workspace. C a multiple of 64 up to MAX_C, Hp a multiple of 64;
// tile_up / tile_down index the tiles above, their BN dividing Hp / C; all
// pointers 16-byte aligned. Launches the up then the down product on
// `stream`; returns the first CUDA error code, 0 on success.
extern "C" int ppea_ffn_fused_bf16(const void* x, const void* w_up,
                                   const void* b_up, const void* w_down,
                                   const void* b_down, void* hidden,
                                   void* out, int M, int C, int Hp,
                                   int tile_up, int tile_down, void* stream) {
  if (M < 1 || C < 64 || C > MAX_C || C % 64 || Hp < 64 || Hp % 64 ||
      tile_up < 0 || tile_up > 3 || tile_down < 0 || tile_down > 3 ||
      Hp % TILE_N[tile_up] || C % TILE_N[tile_down]) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const int err = launch_tile<true>(tile_up, (const bf16*)x,
                                    (const bf16*)w_up, (const float*)b_up,
                                    nullptr, (bf16*)hidden, M, Hp, C, s);
  if (err != 0) return err;
  return launch_tile<false>(tile_down, (const bf16*)hidden,
                            (const bf16*)w_down, (const float*)b_down,
                            (const bf16*)x, (bf16*)out, M, C, Hp, s);
}
