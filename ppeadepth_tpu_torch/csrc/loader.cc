// Native data-loading core: threaded JPEG decode + resize.
//
// The reference's input pipeline runs in torch DataLoader worker
// processes (C++ under the hood). Here the host-side hot path — JPEG
// decode and the resize to network resolution — is a small C++ library
// driven from Python via ctypes; everything downstream (pyramid, jitter,
// flip, intrinsics) runs on-device (ppeadepth_tpu_torch/data/augment.py).
//
// Decode uses libjpeg DCT scaling (1/1, 1/2, 1/4, 1/8) to get close to
// the target size cheaply, then a separable bilinear resample with
// half-pixel centers down/up to the exact target.
//
// C API (ctypes):
//   int ppea_decode_resize(const char* path, int out_w, int out_h,
//                          unsigned char* out /* out_h*out_w*3 */);
//   int ppea_decode_resize_batch(const char* const* paths, int n,
//                                int out_w, int out_h,
//                                unsigned char* out, int n_threads);
// Returns 0 on success; per-image failures zero-fill that slot and set
// the corresponding entry of `status` (batch API) to nonzero.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>  // third_party/libjpeg-turbo (-I)

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

// separable bilinear resize, half-pixel centers, RGB u8
void resize_bilinear(const unsigned char* src, int sw, int sh,
                     unsigned char* dst, int dw, int dh) {
  if (sw == dw && sh == dh) {
    memcpy(dst, src, static_cast<size_t>(sw) * sh * 3);
    return;
  }
  std::vector<float> tmp(static_cast<size_t>(dw) * sh * 3);
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;
  // horizontal pass
  for (int y = 0; y < sh; ++y) {
    const unsigned char* row = src + static_cast<size_t>(y) * sw * 3;
    float* trow = tmp.data() + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(floorf(fx));
      float wx = fx - x0;
      int x1 = x0 + 1;
      if (x0 < 0) x0 = 0;
      if (x1 < 0) x1 = 0;
      if (x0 > sw - 1) x0 = sw - 1;
      if (x1 > sw - 1) x1 = sw - 1;
      for (int c = 0; c < 3; ++c) {
        trow[x * 3 + c] =
            row[x0 * 3 + c] * (1 - wx) + row[x1 * 3 + c] * wx;
      }
    }
  }
  // vertical pass
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(floorf(fy));
    float wy = fy - y0;
    int y1 = y0 + 1;
    if (y0 < 0) y0 = 0;
    if (y1 < 0) y1 = 0;
    if (y0 > sh - 1) y0 = sh - 1;
    if (y1 > sh - 1) y1 = sh - 1;
    const float* r0 = tmp.data() + static_cast<size_t>(y0) * dw * 3;
    const float* r1 = tmp.data() + static_cast<size_t>(y1) * dw * 3;
    unsigned char* drow = dst + static_cast<size_t>(y) * dw * 3;
    for (int i = 0; i < dw * 3; ++i) {
      float v = r0[i] * (1 - wy) + r1[i] * wy;
      drow[i] = static_cast<unsigned char>(v < 0 ? 0 : (v > 255 ? 255 : v + 0.5f));
    }
  }
}

int decode_one(const char* path, int out_w, int out_h, unsigned char* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;

  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  std::vector<unsigned char> buf;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  // DCT scaling: pick the smallest 1/2^k decode that stays >= target
  int denom = 1;
  while (denom < 8 &&
         static_cast<int>(cinfo.image_width) / (denom * 2) >= out_w &&
         static_cast<int>(cinfo.image_height) / (denom * 2) >= out_h) {
    denom *= 2;
  }
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom;

  jpeg_start_decompress(&cinfo);
  const int sw = cinfo.output_width;
  const int sh = cinfo.output_height;
  buf.resize(static_cast<size_t>(sw) * sh * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* rowp = buf.data() +
        static_cast<size_t>(cinfo.output_scanline) * sw * 3;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);

  resize_bilinear(buf.data(), sw, sh, out, out_w, out_h);
  return 0;
}

}  // namespace

extern "C" {

int ppea_decode_resize(const char* path, int out_w, int out_h,
                       unsigned char* out) {
  return decode_one(path, out_w, out_h, out);
}

int ppea_decode_resize_batch(const char* const* paths, int n, int out_w,
                             int out_h, unsigned char* out, int n_threads,
                             int* status) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      unsigned char* slot = out + static_cast<size_t>(i) * out_w * out_h * 3;
      int rc = decode_one(paths[i], out_w, out_h, slot);
      if (status) status[i] = rc;
      if (rc != 0) {
        memset(slot, 0, static_cast<size_t>(out_w) * out_h * 3);
        failures.fetch_add(1);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

}  // extern "C"
