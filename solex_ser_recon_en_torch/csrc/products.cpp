// The product chain's arithmetic (csrc/products.cuh) as C entry points of the
// host library (io/native.py builds this file with ser_io.cpp), for the CPU
// tests: the arithmetic csrc/products.cu runs on the card, on the host,
// held there to the twin (pipeline/products.py, ops/clahe.py,
// ops/rowstats.py).  Each entry point takes the arguments of the card's
// entry point of the same name, less the stream, and walks in plain loops
// what the kernel spreads over threads: the LUT's cumsum and the order
// statistics run bin by bin.  A negative return is an argument it refuses.

#include <stdint.h>

#include "products.cuh"

using namespace solex_products;

namespace {

template <typename T>
void row_gain(const T* img, int h, int w, const float* gain, uint16_t* out) {
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const size_t i = (size_t)y * w + x;
      out[i] = gain_px(value_f32(img[i]), gain[y]);
    }
  }
}

template <typename T>
void blend(const T* img, int h, int w, int tiles_y, int tiles_x,
           int hist_size, const uint16_t* lut, T* out) {
  const int th = (h + (tiles_y - h % tiles_y) % tiles_y) / tiles_y;
  const int tw = (w + (tiles_x - w % tiles_x) % tiles_x) / tiles_x;
  for (int y = 0; y < h; ++y) {
    const Axis ay = axis_at(y, th, tiles_y);
    for (int x = 0; x < w; ++x) {
      const Axis ax = axis_at(x, tw, tiles_x);
      const size_t i = (size_t)y * w + x;
      const uint16_t* r1 = lut + (size_t)ay.t1 * tiles_x * hist_size;
      const uint16_t* r2 = lut + (size_t)ay.t2 * tiles_x * hist_size;
      const size_t a = (size_t)ax.t1 * hist_size + img[i];
      const size_t b = (size_t)ax.t2 * hist_size + img[i];
      out[i] = (T)blend_level(r1[a], r1[b], r2[a], r2[b], ax, ay, hist_size);
    }
  }
}

// the smallest bins whose cumulative counts reach k0 and k1, lerped; the
// highest non-empty bin into *top
float order_stats(const int32_t* hist, int hist_size, int k0, int k1,
                  float low_w, float high_w, int* top) {
  int s0 = hist_size, s1 = hist_size, c = 0;
  *top = -1;
  for (int b = 0; b < hist_size; ++b) {
    c += hist[b];
    if (s0 == hist_size && c >= k0) s0 = b;
    if (s1 == hist_size && c >= k1) s1 = b;
    if (hist[b] != 0) *top = b;
  }
  return lerp_taps(s0, s1, low_w, high_w);
}

}  // namespace

// img: (h, w) u16 (elem_bytes 2) or float32 (4); gain (h,); out u16.
extern "C" int solex_row_gain_host(const void* img, int elem_bytes, int h,
                                   int w, const float* gain, uint16_t* out) {
  if (h < 1 || w < 1) return -1;
  if (elem_bytes == 2) {
    row_gain(static_cast<const uint16_t*>(img), h, w, gain, out);
  } else if (elem_bytes == 4) {
    row_gain(static_cast<const float*>(img), h, w, gain, out);
  } else {
    return -1;
  }
  return 0;
}

// hist (tiles, hist_size) int32; lut (tiles, hist_size) u16 out; full
// (hist_size,) int32 out or null.
extern "C" int solex_clahe_lut_host(const int32_t* hist, int tiles,
                                    int hist_size, int clip, float scale,
                                    uint16_t* lut, int32_t* full) {
  if (tiles < 1 || hist_size < 1 || hist_size > 65536) return -1;
  for (int t = 0; t < tiles; ++t) {
    const int32_t* h = hist + (size_t)t * hist_size;
    int32_t excess = 0;
    for (int b = 0; b < hist_size; ++b) excess += excess_of(h[b], clip);
    const Clip c = clip_plan(clip, excess, hist_size);
    int32_t cdf = 0;
    for (int b = 0; b < hist_size; ++b) {
      cdf += clipped_bin(h[b], b, c);
      lut[(size_t)t * hist_size + b] = (uint16_t)lut_level(cdf, scale,
                                                           hist_size);
    }
  }
  if (full != nullptr) {
    for (int b = 0; b < hist_size; ++b) {
      int32_t s = 0;
      for (int t = 0; t < tiles; ++t) s += hist[(size_t)t * hist_size + b];
      full[b] = s;
    }
  }
  return 0;
}

// img (h, w) u8 with 256 bins (elem_bytes 1) or u16 with 65536 (2); out
// (h, w), the image's type
extern "C" int solex_clahe_blend_host(const void* img, int elem_bytes, int h,
                                      int w, int tiles_y, int tiles_x,
                                      int hist_size, const uint16_t* lut,
                                      void* out) {
  if (h < 1 || w < 1 || tiles_y < 1 || tiles_x < 1) return -1;
  if (elem_bytes == 1 && hist_size == 256) {
    blend(static_cast<const uint8_t*>(img), h, w, tiles_y, tiles_x,
          hist_size, lut, static_cast<uint8_t*>(out));
  } else if (elem_bytes == 2 && hist_size == 65536) {
    blend(static_cast<const uint16_t*>(img), h, w, tiles_y, tiles_x,
          hist_size, lut, static_cast<uint16_t*>(out));
  } else {
    return -1;
  }
  return 0;
}

// hist, full: (65536,) int32 (full may be null); params: 2 floats out (6
// with full)
extern "C" int solex_stretch_params_host(const int32_t* hist, int k0, int k1,
                                         float low_w, float high_w,
                                         const int32_t* full, int f0, int f1,
                                         float f_low_w, float f_high_w,
                                         float* params) {
  const int hist_size = 65536;
  int top;
  const float dark = order_stats(hist, hist_size, k0, k1, low_w, high_w, &top);
  const Limits l = cc_limits(dark, top);
  params[0] = l.lo;
  params[1] = l.hi;
  if (full == nullptr) return 0;
  const float bright =
      bright_of(order_stats(full, hist_size, f0, f1, f_low_w, f_high_w, &top));
  const Limits lh = hc_limits(bright), lp = protus_limits(bright);
  params[2] = lh.lo;
  params[3] = lh.hi;
  params[4] = lp.lo;
  params[5] = lp.hi;
  return 0;
}

// cl1, img: n u16 (img null when hc and pr are); cc, hc, pr: n u16 out
// (hc, pr may be null)
extern "C" int solex_stretch_host(const uint16_t* cl1, const uint16_t* img,
                                  long long n, const float* params,
                                  uint16_t* cc, uint16_t* hc, uint16_t* pr) {
  if (n < 1 || ((hc != nullptr || pr != nullptr) && img == nullptr)) {
    return -1;
  }
  const Limits lc{params[0], params[1]};
  for (long long i = 0; i < n; ++i) cc[i] = stretch_px(value_f32(cl1[i]), lc);
  if (hc != nullptr) {
    const Limits lh{params[2], params[3]};
    for (long long i = 0; i < n; ++i) {
      hc[i] = stretch_px(value_f32(img[i]), lh);
    }
  }
  if (pr != nullptr) {
    const Limits lp{params[4], params[5]};
    for (long long i = 0; i < n; ++i) {
      pr[i] = stretch_px(value_f32(img[i]), lp);
    }
  }
  return 0;
}
