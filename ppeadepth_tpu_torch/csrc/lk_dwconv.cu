// Depthwise convolution, small to large kernels: the merged RepLKNet deploy
// form, the forward and input gradient of the training form, and the eval's
// stride-1 depthwise convs (the stem's 3x3 included).
//
// Replaces: ppeadepth_tpu/kernels/banded_conv.py `banded_depthwise` (:287,
// Pallas body `_kernel`), the TPU kernel behind every merged
// `large_kernel.lkb_reparam` conv (models/replknet.py ReparamLKConv);
// `banded_depthwise_train` (:152), whose forward and d/dx (:173-178, the same
// conv on the spatially flipped kernel) run the same Pallas body; and
// kernels/lk_conv_pallas.py `depthwise_conv2d_pallas` (:70).
//
//   y[b, h, w, c] = sum_{dy, dx} x[b, h + dy - k/2, w + dx - k/2, c] * w[c, dy, dx]
//                   (+ bias[c])
//
// SAME zero padding, stride 1, any odd k <= 31; NHWC memory (an NCHW tensor
// in torch.channels_last). bf16 in and out with bf16 weights, or f32
// throughout; all accumulate in f32. `flip` reads w[c, k-1-dy, k-1-dx]
// in place, so the input gradient needs no flipped copy of the kernel.
//
// Three families of instances; `lk_plan` (kernels/lk_conv.py) picks the
// family from the dtype and k alone, then the tile and the grid from the
// shape, and the host launches with its numbers.
//
// Banded instances, bf16 and k >= 13 (every merged serving conv, and
// training's large-kernel forward and input gradient): on the tensor
// cores. A depthwise conv has no reduction over channels, but each kernel
// row is one over columns: for channel c and kernel row dy, the outputs of
// a 16-column tile are a banded (Toeplitz) matrix of the k taps times a
// 16-column chunk of the input row dy - k/2 above, 48 input columns (32 at
// k <= 17) for 16 outputs, so 56-65 % of the products are taps at k = 27-31
// (40 % at k = 13). Each is an m16n8k16 `mma.sync` with the band as A
// (registers), eight input rows as B (ldmatrix, one row address a lane, so
// the kernel row's shift is an address) and f32 accumulators, summed over
// the kernel rows that land inside the image; bias in the f32 epilogue,
// one bf16 store. Bound: in its products each step (a channel, a kernel
// row) of a warp issues NT x J `mma.sync` and reads 2J+1 band words and
// NT+J-1 input chunks (2 wavefronts each) from shared memory, so the
// tensor cores' `mma.sync` rate and shared memory's bandwidth limit it
// about evenly; before them each block stages its input, 8 bytes of every
// 32-byte pixel sector of NHWC memory, bound by the loads' latency and
// hidden only in part by the other resident blocks. The design keeps the
// products fed: the band is built once per block into shared memory as a
// table of tap pairs (each lane's fragment is 2J+1 aligned 32-bit loads,
// no per-step arithmetic), a warp's task spans up to 5 tiles so each chunk
// feeds J products and each band NT x J, a step's products accumulate
// into different tiles back to back, and 8 warps a block, 2-4 blocks an
// SM, cover the latencies; the staging keeps 16 loads in flight a thread.
// The block stages 4 channels of NI images, transposed into per-channel
// planes with zero columns left and right and a zero row for kernel rows
// off the image; the plan takes the image rows of a product from one image
// (NI=1, 8 rows: the tall stages) or from 2-8 images (the 6-24-row stages,
// where then every kernel row of a product lands in the image).
//
// CUDA-core instances: k is a template parameter at the configurations'
// sizes (3, 5, 7, 13, 27, 29, 31); one instance per family takes any other
// odd k <= 31 at run time (same tiling, weights read from shared memory per
// tap). A thread owns two neighbouring channels (bf16x2 / float2 shared
// loads) of TWT = 10 neighbouring outputs of one row; 10 divides every
// stage width (320, 160, 80, 40, 20), so no thread column idles. Per
// kernel row it keeps that row's k weight pairs in registers and streams
// the TWT + k - 1 input pairs past them: k * TWT * 2 FMAs per 2k + TWT - 1
// shared loads, fully unrolled, no predicate. Kernel rows are clipped to
// those landing inside the image. Shared memory holds the block's k*k
// weights, read as 16-byte vectors of the group's contiguous [channel][k*k]
// run and written transposed to [tap][channel] (flipped in place for dx),
// and the halo rows that exist, min(TH + k - 1, H): rows outside the image
// are neither stored nor multiplied.
//
// Wide instances, k <= 11 (the stem's 3x3, every block's 5x5): bound by
// bytes (9-49 multiply-adds per 2 or 4 bytes in and out). A block takes 128
// bytes of channels (64 bf16, 32 f32) and up to 512 threads at <= 64
// registers (__launch_bounds__(512, 2)). It is persistent: it owns one
// channel group, loads its weights once, walks its share of the (image,
// tile) pairs and keeps the next one or two tiles' halos in flight as
// 16-byte cp.async copies (zero-filled off the image) in a ring of 2 or 3
// buffers while it multiplies the current one, so each SM streams without
// pause.
//
// Narrow instances, f32 and k >= 13 (the f32 eval's large kernels; the
// bf16 ones remain as the banded family's yardstick): bound by CUDA-core
// FMAs (each input value feeds up to k*k = 961 outputs; the halo's load is
// a few per cent). A block takes 8 channels, kept in shared memory as f32
// (bf16 is widened once as it is staged, not once per tap), so the k*k
// weights (31 KB at k=31) and a halo of up to ~80 KB fit twice on an SM:
// two resident blocks (__launch_bounds__(256, 2), <= 128 registers; k=31
// keeps 62 of them for its weights), one loading while the other
// multiplies. The grid has a block per tile; at stages 0 and 2-3 the tile
// is the whole image height, so no thread row idles and no halo row is
// loaded twice. The row pitch is padded to 1 mod 4 pixels, so the four
// 32-byte pixels of four rows that a quarter warp reads fall in four bank
// quarters.
//
// Where it runs: all four encoder stages. The JAX package gated its banded
// kernel to stages 0-1 (banded_conv.py `stage_backends`) because of the
// TPU's 128-lane tile padding at W <= 40; that limit has no Hopper
// counterpart, and the banded instances here build their bands in shared
// memory from the taps, not from precomputed tables. Measured times and
// rates are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int KMAX = 31;  // largest supported kernel
constexpr int TWT = 10;   // output columns per thread
// threads per block (lk_plan keeps to it): __launch_bounds__(MAX, 2) caps
// a thread at 64 registers (wide) and 128 (narrow: k=31 keeps 62 of them
// for its weights)
constexpr int MAX_THREADS_WIDE = 512;
constexpr int MAX_THREADS_NARROW = 256;

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_f32(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ float from_f32(float v) { return v; }

// two neighbouring channels from shared memory, as floats
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void fma2(float2& acc, float2 x, float2 w) {
  acc.x = fmaf(x.x, w.x, acc.x);
  acc.y = fmaf(x.y, w.y, acc.y);
}

// 16 bytes global -> shared without passing through registers; `valid`
// false writes zeros (the source is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// T: element type; K: kernel size, or 0 for the run-time instance (k_rt);
// WIDE: the family; NBUF: halo buffers (2 or 3 wide, 1 narrow). The block
// owns channel group blockIdx.y and walks tiles blockIdx.x, + gridDim.x,
// ... of the n_tiles (image, tile) pairs, each TH rows x TWS strips of TWT
// columns, with tiles i+1 .. i+NBUF-1 in flight while it multiplies tile i
// (the narrow grid has a block per tile: a second resident block does the
// overlapping). `rows`, `pitch`: a halo buffer's rows and row pitch in
// pixels.
template <typename T, int K, bool WIDE, int NBUF>
__global__ void __launch_bounds__(WIDE ? 512 : 256, 2)
lk_dwconv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const T* __restrict__ bias, T* __restrict__ y, int H, int W,
                 int C, int k_rt, int flip, int TH, int TWS, int tiles_h,
                 int tiles_w, int n_tiles, int rows, int pitch) {
  // shared memory holds S: T in the wide instances, f32 in the narrow ones
  // (bf16 widened once while staged, not once per tap)
  using S = typename std::conditional<WIDE, T, float>::type;
  constexpr int CB = WIDE ? 128 / sizeof(T) : 8;  // channels per block
  constexpr int L = CB / 2;            // threads per pixel (channel pairs)
  constexpr int VEC = 16 / sizeof(T);  // elements of x per 16-byte vector
  constexpr int VPP = CB / VEC;        // vectors per pixel (0: bf16 narrow)
  const int k = K > 0 ? K : k_rt;
  const int half = k / 2;
  const int kk = k * k;
  const int TW = TWT * TWS;
  const int WW = TW + k - 1;
  extern __shared__ __align__(16) unsigned char smem[];
  S* ws = reinterpret_cast<S*>(smem);  // [k*k][CB]
  S* xs0 = ws + kk * CB;               // NBUF x [rows][pitch][CB]

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int c0 = blockIdx.y * CB;
  const bool vec = C % VEC == 0;

  // weights, once per block, after the first halo's copies are on their
  // way: consecutive threads read consecutive 16-byte vectors of the
  // group's contiguous [CB][k*k] run (CB * k * k is a whole number of
  // them; element loads if w is not 16-byte aligned); stored as
  // [tap][channel], flipped if asked
  auto stage_weights = [&]() {
    const T* wg = w + (size_t)c0 * kk;
    const int n = min(CB, C - c0) * kk;
    auto put = [&](int i, float v) {
      const int c = i / kk;
      const int t = i - c * kk;
      ws[(flip ? kk - 1 - t : t) * CB + c] = from_f32<S>(i < n ? v : 0.f);
    };
    if (reinterpret_cast<size_t>(w) % 16 == 0) {
#pragma unroll 2
      for (int v = tid; v < CB * kk / VEC; v += nthreads) {
        if ((v + 1) * VEC <= n) {
          const uint4 raw = __ldg(reinterpret_cast<const uint4*>(wg) + v);
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int j = 0; j < VEC; ++j) put(v * VEC + j, to_f32(e[j]));
        } else {  // the group's ragged end: no read past w
          for (int i = v * VEC; i < (v + 1) * VEC; ++i) put(i, i < n ? to_f32(wg[i]) : 0.f);
        }
      }
    } else {
      for (int i = tid; i < CB * kk; i += nthreads) put(i, i < n ? to_f32(wg[i]) : 0.f);
    }
  };

  // the halo rows of tile t inside the image into buffer xs: 16-byte
  // cp.async copies (zero-filled off the image), else element loads
  auto stage = [&](int t, S* xs) {
    const int b = t / (tiles_h * tiles_w);
    const int tile = t - b * (tiles_h * tiles_w);
    const int h0 = (tile / tiles_w) * TH;
    const int iw0 = (tile % tiles_w) * TW - half;
    const int ih_lo = max(0, h0 - half);
    const int n_rows = min(H - 1, h0 + TH - 1 + half) - ih_lo + 1;
    const T* xb = x + (size_t)(b * H + ih_lo) * W * C;
    if constexpr (!std::is_same<S, T>::value) {
      // bf16 -> f32: one 16-byte load is one pixel's 8 channels
      if (vec) {
#pragma unroll 4
        for (int i = tid; i < n_rows * WW; i += nthreads) {
          const int col = i % WW;
          const int row = i / WW;
          const int iw = iw0 + col;
          uint4 v = make_uint4(0, 0, 0, 0);
          if (iw >= 0 && iw < W && c0 < C) {
            v = __ldg(reinterpret_cast<const uint4*>(xb + ((size_t)row * W + iw) * C + c0));
          }
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
          float4* d = reinterpret_cast<float4*>(xs + (row * pitch + col) * CB);
          const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
          const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
          d[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
          d[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
        }
        return;
      }
    } else if (vec) {
      for (int i = tid; i < n_rows * WW * VPP; i += nthreads) {
        const int v = i % VPP;
        const int p = i / VPP;
        const int col = p % WW;
        const int row = p / WW;
        const int iw = iw0 + col;
        const int c = c0 + v * VEC;
        const bool in = iw >= 0 && iw < W && c < C;
        cp_async16(xs + (row * pitch + col) * CB + v * VEC,
                   in ? xb + ((size_t)row * W + iw) * C + c : x, in);
      }
      return;
    }
    {  // C not a multiple of the vector: element loads
      for (int i = tid; i < n_rows * WW * CB; i += nthreads) {
        const int cc = i % CB;
        const int p = i / CB;
        const int col = p % WW;
        const int row = p / WW;
        const int iw = iw0 + col;
        const int c = c0 + cc;
        xs[(row * pitch + col) * CB + cc] = from_f32<S>(
            iw >= 0 && iw < W && c < C ? to_f32(xb[((size_t)row * W + iw) * C + c]) : 0.f);
      }
    }
  };

  const int lane = tid % L;
  const int r = (tid / L) % TH;
  const int s = tid / (L * TH);
  const int c = c0 + 2 * lane;
  float b0 = 0.f, b1 = 0.f;
  if (bias != nullptr && c < C) {
    b0 = to_f32(bias[c]);
    b1 = c + 1 < C ? to_f32(bias[c + 1]) : 0.f;
  }

  // a ring of NBUF halo buffers: the block's tiles i+1 .. i+NBUF-1 are on
  // their way while it multiplies tile i (one commit group per tile, empty
  // past the last)
  const int stride = gridDim.x;
  const int buf_elems = rows * pitch * CB;
#pragma unroll
  for (int i = 0; i < NBUF - 1; ++i) {
    const int tt = blockIdx.x + i * stride;
    if (tt < n_tiles) stage(tt, xs0 + i * buf_elems);
    cp_async_commit();
  }
  stage_weights();
  int buf = 0;
  for (int t = blockIdx.x; t < n_tiles; t += stride) {
    const int tn = t + (NBUF - 1) * stride;
    if (tn < n_tiles) stage(tn, xs0 + (buf + NBUF - 1) % NBUF * buf_elems);
    cp_async_commit();
    cp_async_wait<NBUF - 1>();
    __syncthreads();

    const int b = t / (tiles_h * tiles_w);
    const int tile = t - b * (tiles_h * tiles_w);
    const int h0 = (tile / tiles_w) * TH;
    const int oh = h0 + r;
    const int ow0 = (tile % tiles_w) * TW + s * TWT;
    if (oh < H && ow0 < W && c < C) {
      const S* xs = xs0 + buf * buf_elems;
      const int ih_lo = max(0, h0 - half);
      float2 acc[TWT];
#pragma unroll
      for (int j = 0; j < TWT; ++j) acc[j] = make_float2(0.f, 0.f);
      // kernel rows landing inside the image for this output row
      const int dy_lo = max(0, half - oh);
      const int dy_hi = min(k - 1, H - 1 - oh + half);
      for (int dy = dy_lo; dy <= dy_hi; ++dy) {
        const S* xp = xs + ((oh + dy - half - ih_lo) * pitch + s * TWT) * CB + 2 * lane;
        const S* wp = ws + dy * k * CB + 2 * lane;
        if constexpr (K > 0) {
          float2 wv[K];
#pragma unroll
          for (int dx = 0; dx < K; ++dx) wv[dx] = load2(wp + dx * CB);
#pragma unroll
          for (int m = 0; m < TWT + K - 1; ++m) {
            const float2 xv = load2(xp + m * CB);
#pragma unroll
            for (int j = 0; j < TWT; ++j) {
              if (m - j >= 0 && m - j < K) fma2(acc[j], xv, wv[m - j]);
            }
          }
        } else {
          for (int dx = 0; dx < k; ++dx) {
            const float2 wv = load2(wp + dx * CB);
#pragma unroll
            for (int j = 0; j < TWT; ++j) fma2(acc[j], load2(xp + (j + dx) * CB), wv);
          }
        }
      }
      T* yp = y + ((size_t)(b * H + oh) * W + ow0) * C + c;
#pragma unroll
      for (int j = 0; j < TWT; ++j) {
        if (ow0 + j >= W) break;
        if (C % 2 == 0) {
          store2(yp + (size_t)j * C, acc[j].x + b0, acc[j].y + b1);
        } else {
          yp[(size_t)j * C] = from_f32<T>(acc[j].x + b0);
          if (c + 1 < C) yp[(size_t)j * C + 1] = from_f32<T>(acc[j].y + b1);
        }
      }
    }
    __syncthreads();  // the buffer is free for the next fetch
    buf = (buf + 1) % NBUF;
  }
}

template <typename T, int K, bool WIDE, int NBUF>
int launch(const void* x, const void* w, const void* bias, void* y, int B,
           int H, int W, int C, int k, int flip, int TH, int TWS, int rows,
           int pitch, int smem, int blocks, void* stream) {
  static int opted_in = 48 * 1024;  // dynamic shared memory allowed so far
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        lk_dwconv_kernel<T, K, WIDE, NBUF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = smem;
  }
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TWT * TWS - 1) / (TWT * TWS);
  constexpr int CB = WIDE ? 128 / sizeof(T) : 8;
  const dim3 grid(blocks, (C + CB - 1) / CB);
  lk_dwconv_kernel<T, K, WIDE, NBUF><<<grid, (CB / 2) * TH * TWS, smem,
                               (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w, (const T*)bias, (T*)y, H, W, C, k, flip, TH,
      TWS, tiles_h, tiles_w, B * tiles_h * tiles_w, rows, pitch);
  return (int)cudaGetLastError();
}

// The instances: wide (128 bytes of channels, T in shared memory, a ring of
// 2 or 3 halo buffers) for k <= 7, narrow (8 channels, f32 in shared
// memory, one buffer) for the large kernels, and the run-time-k instance in
// both.
template <typename T>
int dispatch(const void* x, const void* w, const void* bias, void* y, int B,
             int H, int W, int C, int k, int flip, int TH, int TWS, int cb,
             int rows, int pitch, int smem, int blocks, int nbuf, void* stream) {
  constexpr int WIDE_CB = 128 / sizeof(T);
  const bool wide = cb == WIDE_CB;
  const int threads = (cb / 2) * TH * TWS;
  if (k < 1 || k > KMAX || k % 2 == 0 || B < 1 || H < 1 || W < 1 || C < 1 ||
      TH < 1 || TWS < 1 ||
      threads > (wide ? MAX_THREADS_WIDE : MAX_THREADS_NARROW) || (!wide && cb != 8) ||
      pitch < TWT * TWS + k - 1 || rows < min(TH + k - 1, H) || blocks < 1 ||
      (wide ? nbuf != 2 && nbuf != 3 : nbuf != 1)) {
    return (int)cudaErrorInvalidValue;
  }
#define PPEA_LK(KV, WV, NB) \
  launch<T, KV, WV, NB>(x, w, bias, y, B, H, W, C, k, flip, TH, TWS, rows, \
                        pitch, smem, blocks, stream)
#define PPEA_LK_WIDE(KV) (nbuf == 3 ? PPEA_LK(KV, true, 3) : PPEA_LK(KV, true, 2))
  if (wide) {
    switch (k) {
      case 3: return PPEA_LK_WIDE(3);
      case 5: return PPEA_LK_WIDE(5);
      case 7: return PPEA_LK_WIDE(7);
      default: return PPEA_LK_WIDE(0);
    }
  }
  switch (k) {
    case 13: return PPEA_LK(13, false, 1);
    case 27: return PPEA_LK(27, false, 1);
    case 29: return PPEA_LK(29, false, 1);
    case 31: return PPEA_LK(31, false, 1);
    default: return PPEA_LK(0, false, 1);
  }
#undef PPEA_LK_WIDE
#undef PPEA_LK
}

// ---------------------------------------------------------------------------
// The banded instances: bf16, k >= 13, on the tensor cores.
//
// Per channel and kernel row dy, sixteen output columns X0..X0+15 of eight
// image rows are one m16n8k16 product per 16-column chunk of input:
//   out^T[X0 + m, n] += sum_kk T_j[m, kk] * in[n, X0 + 16 j + kk - OFF]
//   T_j[m, kk] = w[dy, 16 j + kk - m + D0],  D0 = k/2 - OFF (0 off the band)
// A = the band T_j in registers, B = the input chunk by ldmatrix from a
// per-channel plane (one row address a lane, so the dy shift is an address),
// D = f32 accumulators. OFF (8 or 16) zero columns lie left of the image in
// the plane, so a chunk starts on a 16-byte boundary and J = 2 (k <= 17) or
// 3 chunks cover the band of 16 outputs.
//
// The band's fragments: lane (g = lane/4, q = lane%4) holds T_j at rows g,
// g+8 and columns 2q, 2q+1, 2q+8, 2q+9, all of them pairs (w[x], w[x+1])
// at x = d + 8 i, d = 2q - g + D0, i = -1 .. 2J-1. Shared memory holds, per
// channel and dy, the table PT[e] = (w[x], w[x+1]), x = e + D0 - 15 (zero
// off the kernel), built by the block from the k taps; the lane reads its
// 2J+1 words at e = 2q - g + 7 + 8 m, m = 0 .. 2J: one 32-bit load each.
// A row of the table is `tlen` = 14 + 16 J words and starts `tstride` =
// k + 15 - D0 words after the previous one: its leading zeros are the
// previous row's trailing zeros.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned& r0, unsigned& r1,
                                        unsigned& r2, unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(unsigned addr, unsigned& r0, unsigned& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float* d, unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

constexpr int BAND_CB = 4;  // channels a block: 8 bytes of bf16 a pixel

// 256-thread blocks the launch bounds keep resident: the accumulators
// (BAND_CB * NT * 4 registers) set it
template <int NT>
constexpr int band_min_blocks() {
  return NT <= 2 ? 4 : (NT <= 3 ? 3 : 2);
}

// a step's operands: the band words and the input chunks of one channel
// and kernel row
template <int NT, int J>
struct BandStep {
  static constexpr int NCH = NT + J - 1;
  unsigned band[2 * J + 1];
  unsigned bq[NCH][2];
  __device__ __forceinline__ void load(const unsigned* tp, unsigned a) {
#pragma unroll
    for (int m = 0; m <= 2 * J; ++m) band[m] = tp[8 * m];
#pragma unroll
    for (int ch = 0; ch < NCH; ch += 2) {
      if (ch + 1 < NCH) {
        ldsm_x4(a + 32u * ch, bq[ch][0], bq[ch][1], bq[ch + 1][0], bq[ch + 1][1]);
      } else {
        ldsm_x2(a + 32u * ch, bq[ch][0], bq[ch][1]);
      }
    }
  }
  // the step's NT * J products, tile-minor so that consecutive products
  // accumulate into different tiles
  __device__ __forceinline__ void mma(float (&acc)[NT][4]) const {
#pragma unroll
    for (int j = 0; j < J; ++j) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        mma_bf16(acc[t], band[2 * j + 1], band[2 * j], band[2 * j + 2], band[2 * j + 1],
                 bq[t + j][0], bq[t + j][1]);
      }
    }
  }
};

// NT: 16-column tiles a warp's task spans; J: chunks a tile reads. The
// block takes channel group blockIdx.x of the NI images and TH output rows
// of row tile blockIdx.y; a warp's task is NR rows of each of the NI images
// (NI * NR = 8, the product's n) by NT tiles of one column segment, for
// all BAND_CB channels. Shared memory: per channel a plane of NI images x
// the halo rows (pitch `pitch`, image stride `img_stride`) and a zero row,
// `chan_stride` elements a channel; then the band tables, a row per
// (channel, dy); then the block's k*k taps.
template <int NT, int J>
__global__ void __launch_bounds__(256, (band_min_blocks<NT>()))
lk_dwconv_kernel_banded(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w,
                        const __nv_bfloat16* __restrict__ bias,
                        __nv_bfloat16* __restrict__ y, int B, int H, int W, int C,
                        int k, int flip, int NI, int NR, int TH, int pitch,
                        int img_stride, int chan_stride, int tlen, int segs,
                        int tiles_h) {
  constexpr int CB = BAND_CB;
  constexpr int SU = 8;  // staging items a thread has in flight
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned* pt = reinterpret_cast<unsigned*>(smem + (size_t)CB * chan_stride * 2);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int half = k / 2;
  const int off = (half + 7) & ~7;  // zero columns left of the image
  const int xmin = half - off - 15;  // the band table's first x
  const int tstride = k - xmin;      // words from one table row to the next
  const int c0 = blockIdx.x * CB;
  const int b0 = (blockIdx.y / tiles_h) * NI;
  const int h0 = (blockIdx.y % tiles_h) * TH;
  const int r_lo = max(0, h0 - half);
  const int r_hi = min(H - 1, h0 + TH - 1 + half);
  const int n_rows = r_hi - r_lo + 1;
  const int zero_row = NI * img_stride;  // a channel plane's zero row
  const int cols = (segs * NT + J - 1) * 16;  // plane columns the tasks read
  // the taps after the tables, on a 16-byte boundary
  __nv_bfloat16* wsm =
      reinterpret_cast<__nv_bfloat16*>(pt + (((CB * k - 1) * tstride + tlen + 3) & ~3));

  // the block's taps, [CB][k*k] as they lie in w, into shared memory:
  // 8-byte vectors where w allows, else elements
  {
    const int kk = k * k;
    const int n = min(CB, C - c0) * kk;
    const __nv_bfloat16* wg = w + (size_t)c0 * kk;
    if (reinterpret_cast<size_t>(wg) % 8 == 0) {
      for (int v = tid; v < n / 4; v += blockDim.x) {
        reinterpret_cast<uint2*>(wsm)[v] = __ldg(reinterpret_cast<const uint2*>(wg) + v);
      }
      for (int i = n / 4 * 4 + tid; i < n; i += blockDim.x) wsm[i] = wg[i];
    } else {
      for (int i = tid; i < n; i += blockDim.x) wsm[i] = wg[i];
    }
  }
  // the input: NI images x the tile's halo rows x `cols` plane columns,
  // two columns an item (two pixels' CB channels in, a word to each plane
  // out), SU items' loads in flight a thread before their stores; zeros
  // left and right of the image
  {
    const int ni = min(NI, B - b0);  // images of the group that exist
    const int hc = cols / 2;
    const int items = ni * n_rows * hc;
    for (int base = tid; base < items; base += SU * blockDim.x) {
      uint2 v[SU][2];
      int dst[SU];
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        const int it = base + u * blockDim.x;
        const int rr = it / hc;
        const int s2 = 2 * (it - rr * hc);
        const int i = rr / n_rows;
        const int r = rr - i * n_rows;
        dst[u] = it < items ? i * img_stride + r * pitch + s2 : -1;
        const __nv_bfloat16* xp =
            x + (((long long)(b0 + i) * H + r_lo + r) * W + s2 - off) * C + c0;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int xx = s2 - off + h2;
          v[u][h2] = make_uint2(0u, 0u);
          if (it < items && xx >= 0 && xx < W) {
            if (C % CB == 0) {
              v[u][h2] = __ldg(reinterpret_cast<const uint2*>(xp + (size_t)h2 * C));
            } else {  // C not a multiple of CB: element loads
              const unsigned short* xe =
                  reinterpret_cast<const unsigned short*>(xp + (size_t)h2 * C);
              unsigned e[CB];
#pragma unroll
              for (int c = 0; c < CB; ++c) e[c] = c0 + c < C ? xe[c] : 0u;
              v[u][h2] = make_uint2(e[0] | e[1] << 16, e[2] | e[3] << 16);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        if (dst[u] < 0) continue;
        unsigned* d = reinterpret_cast<unsigned*>(xs + dst[u]);
        d[0] = __byte_perm(v[u][0].x, v[u][1].x, 0x5410);
        d[chan_stride / 2] = __byte_perm(v[u][0].x, v[u][1].x, 0x7632);
        d[chan_stride] = __byte_perm(v[u][0].y, v[u][1].y, 0x5410);
        d[3 * chan_stride / 2] = __byte_perm(v[u][0].y, v[u][1].y, 0x7632);
      }
    }
  }
  __syncthreads();  // the taps are in shared memory
  // band tables: a warp per (channel, dy) row, which writes its first
  // `tstride` words; lane j < k holds tap j of the row (flipped in place
  // for dx), shuffled to each entry's pair. Then the last row's tail, and
  // the zero rows.
  {
    const int kk = k * k;
    const unsigned short* wr = reinterpret_cast<const unsigned short*>(wsm);
    for (int rw = warp; rw < CB * k; rw += nwarps) {
      const int c = rw / k;
      const int dy = rw - c * k;
      const int dyy = flip ? k - 1 - dy : dy;
      const unsigned v = lane < k && c0 + c < C
                             ? wr[c * kk + dyy * k + (flip ? k - 1 - lane : lane)] : 0u;
      for (int e0 = 0; e0 < tstride; e0 += 32) {
        const int e = e0 + lane;
        const int xl = e + xmin;
        const unsigned lo = __shfl_sync(0xffffffffu, v, xl & 31);
        const unsigned hi = __shfl_sync(0xffffffffu, v, (xl + 1) & 31);
        if (e < tstride) {
          pt[rw * tstride + e] = (xl >= 0 && xl < k ? lo : 0u) |
                                 ((xl + 1 >= 0 && xl + 1 < k ? hi : 0u) << 16);
        }
      }
    }
    for (int e = CB * k * tstride + tid; e < (CB * k - 1) * tstride + tlen; e += blockDim.x) {
      pt[e] = 0u;
    }
    for (int i = tid; i < CB * (pitch / 2); i += blockDim.x) {
      const int c = i / (pitch / 2);
      reinterpret_cast<unsigned*>(xs + c * chan_stride + zero_row)[i - c * (pitch / 2)] = 0u;
    }
  }
  __syncthreads();

  float bv[CB];
#pragma unroll
  for (int c = 0; c < CB; ++c) {
    bv[c] = bias != nullptr && c0 + c < C ? __bfloat162float(bias[c0 + c]) : 0.f;
  }
  const int g = lane >> 2;
  const int q = lane & 3;
  const unsigned* pt_lane = pt + (2 * q - g + 7);
  const unsigned xs_s = static_cast<unsigned>(__cvta_generic_to_shared(xs));
  // the lane's ldmatrix row: image row n = lane % 8 of the group; lanes
  // 8-15 address columns 8-15 of a chunk, lanes 16-31 the next chunk
  const int n_l = lane & 7;
  const int col_l = ((lane >> 3) & 1) * 8 + (lane >> 4) * 16;
  const int y_end = min(H, h0 + TH);
  const int tasks = TH / NR * segs;

  for (int task = warp; task < tasks; task += nwarps) {
    const int rg = task / segs;
    const int seg = task - rg * segs;
    const int y0 = h0 + rg * NR;
    const int ylast = min(y0 + NR, y_end) - 1;
    if (ylast < y0) continue;
    const int dy_lo = max(0, half - ylast);
    const int dy_hi = min(k - 1, half + H - 1 - y0);
    const int img_l = n_l / NR;
    const int y_l = y0 + n_l - img_l * NR;
    const bool row_ok = y_l <= ylast && b0 + img_l < B;
    const int col0 = seg * NT * 16;

    float acc[CB][NT][4];
#pragma unroll
    for (int c = 0; c < CB; ++c)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][t][e] = 0.f;

    // steps (dy, c): a step's operands, then its products
    const unsigned c_bytes = 2u * chan_stride;
    const int c_words = k * tstride;
    BandStep<NT, J> st;
    for (int dy = dy_lo; dy <= dy_hi; ++dy) {
      const int r = y_l + dy - half;
      const int rowoff = row_ok && r >= 0 && r < H ? img_l * img_stride + (r - r_lo) * pitch
                                                   : zero_row;
      const unsigned a_row = xs_s + 2u * (rowoff + col0 + col_l);
      const unsigned* tp = pt_lane + dy * tstride;
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        st.load(tp + c * c_words, a_row + c * c_bytes);
        st.mma(acc[c]);
      }
    }

    // epilogue: D element e of tile t is output column col0 + 16 t + g
    // (+ 8 for e >= 2) of group row n = 2 q + (e & 1); its CB channels go
    // out as one store
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ox = col0 + 16 * t + g + 8 * (e >> 1);
        const int n = 2 * q + (e & 1);
        const int img = n / NR;
        const int oy = y0 + n - img * NR;
        const int b = b0 + img;
        if (ox >= W || oy > ylast || b >= B) continue;
        __nv_bfloat16* yp = y + (((size_t)b * H + oy) * W + ox) * C + c0;
        if (C % CB == 0) {
          const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[0][t][e] + bv[0], acc[1][t][e] + bv[1]);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[2][t][e] + bv[2], acc[3][t][e] + bv[3]);
          *reinterpret_cast<uint2*>(yp) = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                                     *reinterpret_cast<const unsigned*>(&hi));
        } else {
#pragma unroll
          for (int c = 0; c < CB; ++c) {
            if (c0 + c < C) yp[c] = __float2bfloat16(acc[c][t][e] + bv[c]);
          }
        }
      }
    }
  }
}

template <int NT, int J>
int launch_banded(const void* x, const void* w, const void* bias, void* y, const int* a,
                  void* stream) {
  // a: as ppea_lk_dwconv_banded_bf16 reads it
  static int opted_in = 48 * 1024;
  const int smem = a[16];
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        lk_dwconv_kernel_banded<NT, J>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = smem;
  }
  const dim3 grid((a[3] + BAND_CB - 1) / BAND_CB, a[17] * a[14]);
  lk_dwconv_kernel_banded<NT, J><<<grid, 32 * a[15], smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const __nv_bfloat16*)bias,
      (__nv_bfloat16*)y, a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], a[9],
      a[10], a[11], a[12], a[13], a[14]);
  return (int)cudaGetLastError();
}

int dispatch_banded(const void* x, const void* w, const void* bias, void* y, const int* a,
                    void* stream) {
#define PPEA_BAND(NTV, JV) launch_banded<NTV, JV>(x, w, bias, y, a, stream)
  switch (a[19] * 8 + a[18]) {  // J, NT
    case 17: return PPEA_BAND(1, 2);
    case 18: return PPEA_BAND(2, 2);
    case 19: return PPEA_BAND(3, 2);
    case 20: return PPEA_BAND(4, 2);
    case 21: return PPEA_BAND(5, 2);
    case 25: return PPEA_BAND(1, 3);
    case 26: return PPEA_BAND(2, 3);
    case 27: return PPEA_BAND(3, 3);
    case 28: return PPEA_BAND(4, 3);
    case 29: return PPEA_BAND(5, 3);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PPEA_BAND
}

}  // namespace

// x, y: [B, H, W, C] (NHWC memory, 16-byte aligned); w: [C, K, K]; bias:
// [C] or null; all bf16 (`_bf16`) or all f32 (`_f32`). args: B, H, W, C,
// K, flip (!= 0: convolve with w[c, K-1-dy, K-1-dx]), then lk_plan's TH,
// TWS, cb (channels per block), rows and pitch (the halo's), smem (bytes),
// blocks (per channel group) and nbuf (halo buffers: 1 narrow, 2 or 3
// wide); one array, so a call converts six arguments, not nineteen. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for arguments no instance
// takes).
extern "C" int ppea_lk_dwconv_bf16(const void* x, const void* w,
                                   const void* bias, void* y, const int* a,
                                   void* stream) {
  return dispatch<__nv_bfloat16>(x, w, bias, y, a[0], a[1], a[2], a[3], a[4],
                                 a[5], a[6], a[7], a[8], a[9], a[10], a[11],
                                 a[12], a[13], stream);
}

extern "C" int ppea_lk_dwconv_f32(const void* x, const void* w,
                                  const void* bias, void* y, const int* a,
                                  void* stream) {
  return dispatch<float>(x, w, bias, y, a[0], a[1], a[2], a[3], a[4], a[5],
                         a[6], a[7], a[8], a[9], a[10], a[11], a[12], a[13],
                         stream);
}

// x, y: [B, H, W, C] bf16 (NHWC memory, 16-byte aligned); w: [C, K, K];
// bias: [C] or null. a (20 ints, lk_conv._args of a BandPlan): B, H, W, C,
// K, flip, then lk_plan's NI, NR, TH, pitch, image stride, channel stride
// (elements), table words per (channel, dy), column segments, row tiles,
// warps, smem (bytes), image groups, NT and J. Launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for arguments no
// instance takes).
extern "C" int ppea_lk_dwconv_banded_bf16(const void* x, const void* w,
                                          const void* bias, void* y, const int* a,
                                          void* stream) {
  const int B = a[0], H = a[1], W = a[2], C = a[3], k = a[4];
  const int NI = a[6], NR = a[7], TH = a[8], pitch = a[9], img_stride = a[10];
  const int chan_stride = a[11], tlen = a[12], segs = a[13], tiles_h = a[14];
  const int warps = a[15], NT = a[18], J = a[19], CB = BAND_CB;
  const int half = k / 2, off = (half + 7) & ~7;
  if (k < 13 || k > KMAX || k % 2 == 0 || B < 1 || H < 1 || W < 1 || C < 1 ||
      NI * NR != 8 || (NR & (NR - 1)) != 0 || TH < NR ||
      TH % NR != 0 || J != (half + off + 31) / 16 || tlen != 14 + 16 * J ||
      pitch % 8 != 0 || pitch < (segs * NT + J - 1) * 16 || img_stride % 8 != 0 ||
      img_stride < min(TH + k - 1, H) * pitch || chan_stride < NI * img_stride + pitch ||
      chan_stride % 8 != 0 ||
      a[16] < CB * chan_stride * 2 + (((CB * k - 1) * (k + 15 + off - half) + tlen + 3) & ~3) * 4 +
                  CB * k * k * 2 ||
      tiles_h * TH < H || segs * NT * 16 < W || warps < 1 || warps > 8 || a[17] * NI < B) {
    return (int)cudaErrorInvalidValue;
  }
  return dispatch_banded(x, w, bias, y, a, stream);
}
