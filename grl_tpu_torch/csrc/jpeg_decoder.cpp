// grl_tpu_torch host routine: JPEG decode + bilinear resize (a copy of
// grl_tpu/native/jpeg_decoder.cpp; the port keeps its own source).
//
// Decode + resize is a C routine on top of libjpeg, called through ctypes,
// which releases the GIL for the duration of the call, so the loader's
// thread pool decodes frames concurrently without worker processes. It
// runs on the host; nothing here touches the card.
//
// Build (grl_tpu_torch/data/jpeg.py does it at first use, into build/host/):
//   g++ -O3 -shared -fPIC jpeg_decoder.cpp -ljpeg -o libgrljpeg.so
//
// API (C linkage):
//   grl_decode_resize(buf, len, out_h, out_w, out_rgb) -> 0 on success
//   grl_decode_dims(buf, len, &h, &w)                  -> 0 on success

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cmath>
#include <cstring>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// 100 MP cap: rejects hostile headers (a truncated/malicious JPEG can
// declare 65500x65500 ~ 12.8 GB) before the allocation, independent of
// the bad_alloc guard at the extern "C" boundary.
constexpr size_t kMaxPixels = 100u * 1000 * 1000;

// Decode a JPEG buffer to tightly-packed RGB; returns empty on failure.
bool decode_rgb(const uint8_t* buf, size_t len, std::vector<uint8_t>* out,
                int* height, int* width) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  const int h = cinfo.output_height;
  const int w = cinfo.output_width;
  if (static_cast<size_t>(h) * w > kMaxPixels) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  out->resize(static_cast<size_t>(h) * w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *height = h;
  *width = w;
  return true;
}

// Separable triangle-filter (bilinear) resample following PIL's
// convention: the filter support scales with the downscale factor
// (antialiasing), coefficients are normalized per output pixel and
// applied in 8.22 fixed point, horizontal pass then vertical pass —
// so output matches PIL.Image.resize(..., BILINEAR) on both up- and
// downscale (RandomSizedRectCrop / RectScale parity for datasets whose
// frames are not stored at the target size).

constexpr int kPrecisionBits = 32 - 8 - 2;

inline uint8_t clip8(int64_t v) {
  v >>= kPrecisionBits;
  if (v < 0) return 0;
  if (v > 255) return 255;
  return static_cast<uint8_t>(v);
}

double triangle_filter(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

// Per-output-pixel source window + normalized fixed-point coefficients.
void precompute_coeffs(int in_size, int out_size, std::vector<int>* bounds,
                       std::vector<int>* kk, int* ksize_out) {
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = filterscale;  // triangle filter support = 1.0
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  bounds->assign(static_cast<size_t>(out_size) * 2, 0);
  kk->assign(static_cast<size_t>(out_size) * ksize, 0);
  std::vector<double> w(ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double ww = 0.0;
    const double ss = 1.0 / filterscale;
    for (int x = 0; x < xmax; ++x) {
      w[x] = triangle_filter((x + xmin - center + 0.5) * ss);
      ww += w[x];
    }
    int* k = kk->data() + static_cast<size_t>(xx) * ksize;
    for (int x = 0; x < xmax; ++x) {
      const double v = ww == 0.0 ? 0.0 : w[x] / ww;
      k[x] = v < 0 ? static_cast<int>(-0.5 + v * (1 << kPrecisionBits))
                   : static_cast<int>(0.5 + v * (1 << kPrecisionBits));
    }
    (*bounds)[static_cast<size_t>(xx) * 2] = xmin;
    (*bounds)[static_cast<size_t>(xx) * 2 + 1] = xmax;
  }
  *ksize_out = ksize;
}

void resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                     int dw) {
  // horizontal pass: (sh, sw) -> (sh, dw)
  std::vector<int> hb, hk;
  int hks = 0;
  precompute_coeffs(sw, dw, &hb, &hk, &hks);
  std::vector<uint8_t> tmp(static_cast<size_t>(sh) * dw * 3);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * sw * 3;
    uint8_t* orow = tmp.data() + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const int xmin = hb[static_cast<size_t>(x) * 2];
      const int xmax = hb[static_cast<size_t>(x) * 2 + 1];
      const int* k = hk.data() + static_cast<size_t>(x) * hks;
      int64_t acc[3] = {1 << (kPrecisionBits - 1), 1 << (kPrecisionBits - 1),
                        1 << (kPrecisionBits - 1)};
      for (int i = 0; i < xmax; ++i) {
        const uint8_t* px = row + static_cast<size_t>(xmin + i) * 3;
        acc[0] += static_cast<int64_t>(px[0]) * k[i];
        acc[1] += static_cast<int64_t>(px[1]) * k[i];
        acc[2] += static_cast<int64_t>(px[2]) * k[i];
      }
      orow[x * 3 + 0] = clip8(acc[0]);
      orow[x * 3 + 1] = clip8(acc[1]);
      orow[x * 3 + 2] = clip8(acc[2]);
    }
  }
  // vertical pass: (sh, dw) -> (dh, dw)
  std::vector<int> vb, vk;
  int vks = 0;
  precompute_coeffs(sh, dh, &vb, &vk, &vks);
  for (int y = 0; y < dh; ++y) {
    const int ymin = vb[static_cast<size_t>(y) * 2];
    const int ymax = vb[static_cast<size_t>(y) * 2 + 1];
    const int* k = vk.data() + static_cast<size_t>(y) * vks;
    uint8_t* orow = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      int64_t acc[3] = {1 << (kPrecisionBits - 1), 1 << (kPrecisionBits - 1),
                        1 << (kPrecisionBits - 1)};
      for (int i = 0; i < ymax; ++i) {
        const uint8_t* px =
            tmp.data() + (static_cast<size_t>(ymin + i) * dw + x) * 3;
        acc[0] += static_cast<int64_t>(px[0]) * k[i];
        acc[1] += static_cast<int64_t>(px[1]) * k[i];
        acc[2] += static_cast<int64_t>(px[2]) * k[i];
      }
      orow[x * 3 + 0] = clip8(acc[0]);
      orow[x * 3 + 1] = clip8(acc[1]);
      orow[x * 3 + 2] = clip8(acc[2]);
    }
  }
}

}  // namespace

extern "C" {

// NOTE: C++ exceptions (e.g. std::bad_alloc from vector::resize on a
// hostile header) must not unwind through the C ABI into ctypes — that
// is std::terminate. Every entry point catches and returns rc != 0 so
// the Python side falls back to PIL (grl_tpu_torch/data/jpeg.py).

int grl_decode_dims(const uint8_t* buf, size_t len, int* h, int* w) {
  try {
    std::vector<uint8_t> rgb;
    return decode_rgb(buf, len, &rgb, h, w) ? 0 : 1;
  } catch (...) {
    return 1;
  }
}

// Decode `buf` and write (out_h, out_w, 3) RGB into out_rgb.
int grl_decode_resize(const uint8_t* buf, size_t len, int out_h, int out_w,
                      uint8_t* out_rgb) {
  try {
    std::vector<uint8_t> rgb;
    int h = 0, w = 0;
    if (!decode_rgb(buf, len, &rgb, &h, &w)) return 1;
    if (h == out_h && w == out_w) {
      std::memcpy(out_rgb, rgb.data(), rgb.size());
    } else {
      resize_bilinear(rgb.data(), h, w, out_rgb, out_h, out_w);
    }
    return 0;
  } catch (...) {
    return 1;
  }
}

}  // extern "C"
