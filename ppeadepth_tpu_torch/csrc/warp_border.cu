// Border-mode bilinear warp (align_corners=True) of the photometric loss,
// and its gradient with respect to the sample coordinates.
//
// Replaces: ppeadepth_tpu/kernels/warp_mxu.py `grid_sample_border_mxu`
// (Pallas bodies `_fwd_kernel` and `_bwd_kernel`), the TPU kernel behind
// every warp of train/step.py `_warp_frames`.
//
//   x = (cx + 1) / 2 * (W - 1), clamped to [0, W - 1]; y likewise in H
//   out[n, i, j, c] = bilinear(img[n, :, :, c], x, y), corners x0 = floor(x),
//                     x1 = min(x0 + 1, W - 1) (y0, y1 likewise)
//   dcx = sum_c g[c] * ((v01 - v00) * (1 - wy) + (v11 - v10) * wy)
//         * [0 <= x <= W - 1] * (W - 1) / 2          (dcy likewise)
//
// The derivative is one-sided at integer coordinates and vanishes at the
// right and bottom borders (the clamped x1, y1), as the Pallas kernel's and
// torch's. The image is stop-gradient on the TPU path too: no image
// gradient is computed.
//
// What bounds it on Hopper: bytes. Per branch of the training step (24
// warps of 192x640x3 f32) the forward reads the coordinates (23.6 MB) and
// the image (35.4 MB) and writes the output (35.4 MB); the backward reads
// image, coordinates and output gradient and writes the coordinate
// gradient (118 MB), against a few tens of f32 operations per pixel.
//
// Design: the TPU kernel turned the gather into 0/1-indicator matmuls
// because Mosaic has no dynamic gather, and defaulted to a bf16 image
// operand for the MXU. Hopper gathers through L1, so the corners' channels
// are read directly from the NHWC f32 image, in exact f32 (the Pallas
// kernel's "highest"/float32 mode). The backward recomputes the corners
// instead of saving them.
//
// The forward is a grid over (row tiles, items, row segments) of one item's
// output rows, one pixel a thread in blocks of 64 x 4, so no index needs a
// division (a flat 64-bit pixel index did), with C a template parameter.
// Each output is the same f32 expression in the same order as in the
// earlier one-pixel-a-thread form with a flat index, so the bits are the
// same. On the H100 this took [24,192,640,3] from 49.3 to 38.7-39.2 us;
// 2 and 4 pixels a thread (16-byte coordinate loads and output stores)
// measured 45.7-47.1 and 57.9-63.8 us (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int MAXC = 4;  // the photometric warp samples RGB images

struct Corners {
  int i00, i01, i10, i11;  // pixel offsets of the four corners
  float wx, wy;            // fractional parts
  float mx, my;            // 1 where the unclamped coordinate is in range
};

__device__ __forceinline__ Corners corners(float cx, float cy, int H, int W) {
  Corners k;
  const float x = (cx + 1.f) * 0.5f * (float)(W - 1);
  const float y = (cy + 1.f) * 0.5f * (float)(H - 1);
  // fmaxf/fminf return the other operand for a NaN, so a non-finite
  // coordinate samples a border pixel instead of indexing out of bounds
  const float xc = fminf(fmaxf(x, 0.f), (float)(W - 1));
  const float yc = fminf(fmaxf(y, 0.f), (float)(H - 1));
  const float fx = floorf(xc);
  const float fy = floorf(yc);
  const int x0 = (int)fx;
  const int y0 = (int)fy;
  const int x1 = min(x0 + 1, W - 1);
  const int y1 = min(y0 + 1, H - 1);
  k.wx = xc - fx;
  k.wy = yc - fy;
  k.i00 = y0 * W + x0;
  k.i01 = y0 * W + x1;
  k.i10 = y1 * W + x0;
  k.i11 = y1 * W + x1;
  k.mx = (x >= 0.f && x <= (float)(W - 1)) ? 1.f : 0.f;
  k.my = (y >= 0.f && y <= (float)(H - 1)) ? 1.f : 0.f;
  return k;
}

constexpr int FWD_TX = 64;  // the forward's block: pixels along a row
constexpr int FWD_TY = 4;   // and rows

// grid (row tiles of an item, items, row segments); block (FWD_TX, FWD_TY)
template <int C>
__global__ void __launch_bounds__(FWD_TX * FWD_TY)
warp_fwd_kernel(const float* __restrict__ img, const float2* __restrict__ coords,
                float* __restrict__ out, int H, int W, int Ho, int Wo) {
  const int i = blockIdx.x * FWD_TY + threadIdx.y;
  const int j = blockIdx.z * FWD_TX + threadIdx.x;
  if (i >= Ho || j >= Wo) return;
  const int n = blockIdx.y;
  const size_t p = ((size_t)n * Ho + i) * Wo + j;
  const float2 c = __ldg(coords + p);
  const Corners k = corners(c.x, c.y, H, W);
  const float* base = img + (size_t)n * H * W * C;
  const float w00 = (1.f - k.wx) * (1.f - k.wy);
  const float w01 = k.wx * (1.f - k.wy);
  const float w10 = (1.f - k.wx) * k.wy;
  const float w11 = k.wx * k.wy;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const float v00 = __ldg(base + k.i00 * C + ch);
    const float v01 = __ldg(base + k.i01 * C + ch);
    const float v10 = __ldg(base + k.i10 * C + ch);
    const float v11 = __ldg(base + k.i11 * C + ch);
    out[p * C + ch] = v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11;
  }
}

__global__ void __launch_bounds__(NTHREADS)
warp_bwd_kernel(const float* __restrict__ img, const float2* __restrict__ coords,
                const float* __restrict__ g, float2* __restrict__ dcoords,
                long long P, int HWo, int H, int W, int C) {
  const long long p = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (p >= P) return;
  const int n = (int)(p / HWo);
  const float2 c = coords[p];
  const Corners k = corners(c.x, c.y, H, W);
  const float* base = img + (size_t)n * H * W * C;
  float gx = 0.f, gy = 0.f;
  for (int ch = 0; ch < C; ++ch) {
    const float v00 = __ldg(base + (size_t)k.i00 * C + ch);
    const float v01 = __ldg(base + (size_t)k.i01 * C + ch);
    const float v10 = __ldg(base + (size_t)k.i10 * C + ch);
    const float v11 = __ldg(base + (size_t)k.i11 * C + ch);
    const float gc = g[p * C + ch];
    gx += gc * ((v01 - v00) * (1.f - k.wy) + (v11 - v10) * k.wy);
    gy += gc * ((v10 - v00) * (1.f - k.wx) + (v11 - v01) * k.wx);
  }
  dcoords[p] = make_float2(gx * k.mx * (0.5f * (float)(W - 1)),
                           gy * k.my * (0.5f * (float)(H - 1)));
}

bool bad_shape(int N, int H, int W, int C, int Ho, int Wo) {
  return N < 1 || H < 1 || W < 1 || C < 1 || C > MAXC || Ho < 1 || Wo < 1 ||
         (long long)H * W * C >= (1ll << 31);
}

}  // namespace

// img: [N, H, W, C] f32 (NHWC, contiguous); coords: [N, Ho, Wo, 2] f32
// normalised (x, y), 8-byte aligned; out: [N, Ho, Wo, C] f32. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int ppea_warp_border_fwd(const void* img, const void* coords,
                                    void* out, int N, int H, int W, int C,
                                    int Ho, int Wo, void* stream) {
  if (bad_shape(N, H, W, C, Ho, Wo) || N > 65535 ||
      (Wo + FWD_TX - 1) / FWD_TX > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((Ho + FWD_TY - 1) / FWD_TY, N, (Wo + FWD_TX - 1) / FWD_TX);
  const dim3 block(FWD_TX, FWD_TY);
  cudaStream_t s = (cudaStream_t)stream;
  const float* im = (const float*)img;
  const float2* co = (const float2*)coords;
  float* o = (float*)out;
  switch (C) {
    case 1: warp_fwd_kernel<1><<<grid, block, 0, s>>>(im, co, o, H, W, Ho, Wo); break;
    case 2: warp_fwd_kernel<2><<<grid, block, 0, s>>>(im, co, o, H, W, Ho, Wo); break;
    case 3: warp_fwd_kernel<3><<<grid, block, 0, s>>>(im, co, o, H, W, Ho, Wo); break;
    default: warp_fwd_kernel<4><<<grid, block, 0, s>>>(im, co, o, H, W, Ho, Wo);
  }
  return (int)cudaGetLastError();
}

// g: [N, Ho, Wo, C] f32 gradient of the output; dcoords: [N, Ho, Wo, 2] f32
// gradient of the coordinates. The other arguments as the forward's.
extern "C" int ppea_warp_border_bwd(const void* img, const void* coords,
                                    const void* g, void* dcoords, int N, int H,
                                    int W, int C, int Ho, int Wo,
                                    void* stream) {
  if (bad_shape(N, H, W, C, Ho, Wo)) return (int)cudaErrorInvalidValue;
  const long long P = (long long)N * Ho * Wo;
  const unsigned blocks = (unsigned)((P + NTHREADS - 1) / NTHREADS);
  warp_bwd_kernel<<<blocks, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const float*)img, (const float2*)coords, (const float*)g,
      (float2*)dcoords, P, Ho * Wo, H, W, C);
  return (int)cudaGetLastError();
}
