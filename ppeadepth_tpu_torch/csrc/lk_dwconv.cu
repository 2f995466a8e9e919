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
// throughout; both accumulate in f32. `flip` reads w[c, k-1-dy, k-1-dx]
// in place, so the input gradient needs no flipped copy of the kernel.
//
// One template, two families of instances; `lk_plan` (kernels/lk_conv.py)
// picks the instance, the tile and the grid, and the host launches with its
// numbers. Common to both:
//   * k is a template parameter at the configurations' sizes (3, 5, 7, 13,
//     27, 29, 31); one instance per family takes any other odd k <= 31 at
//     run time (same tiling, weights read from shared memory per tap);
//   * a thread owns two neighbouring channels (bf16x2 / float2 shared
//     loads) of TWT = 10 neighbouring outputs of one row; 10 divides every
//     stage width (320, 160, 80, 40, 20), so no thread column idles. Per
//     kernel row it keeps that row's k weight pairs in registers and
//     streams the TWT + k - 1 input pairs past them: k * TWT * 2 FMAs per
//     2k + TWT - 1 shared loads, fully unrolled, no predicate. Kernel rows
//     are clipped to those landing inside the image;
//   * shared memory holds the block's k*k weights, read as 16-byte vectors
//     of the group's contiguous [channel][k*k] run and written transposed
//     to [tap][channel] (flipped in place for dx), and the halo rows that
//     exist, min(TH + k - 1, H): rows outside the image are neither
//     stored nor multiplied.
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
// Narrow instances, k >= 13 (the large kernels): bound by CUDA-core FMAs
// (each input value feeds up to k*k = 961 outputs; the halo's load is a
// few per cent). A block takes 8 channels, kept in shared memory as f32
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
// The tensor cores stay idle: a depthwise conv has no reduction over
// channels to feed them (a Toeplitz form of the bf16 path, what the TPU
// did on its MXU, is a different algorithm against a different bound).
//
// Where it runs: all four encoder stages. The JAX package gated its banded
// kernel to stages 0-1 (banded_conv.py `stage_backends`) because of the
// TPU's 128-lane tile padding at W <= 40; that limit has no Hopper
// counterpart. Measured times and rates are in PERF.md.

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
