// The device Canny's per-pixel arithmetic (csrc/canny.cuh) as C entry points
// of the host library (io/native.py builds this file with ser_io.cpp), for
// the CPU tests: the arithmetic csrc/canny.cu runs on the card, on the host,
// held there to ops/canny.py's twin.  The image-level entry walks the image
// in plain loops (no tiles) and floods the hysteresis over the whole image
// with the kernel's rule.  A negative return is an argument it refuses.

#include <algorithm>
#include <vector>

#include "canny.cuh"

using namespace solex_canny;

extern "C" int solex_canny_fma_host(const float* a, const float* b,
                                    const float* c, long long n, float* out) {
  for (long long i = 0; i < n; ++i) {
    out[i] = solex_canny::fma(a[i], b[i], c[i]);
  }
  return 0;
}

extern "C" int solex_canny_hypot_host(const float* y, const float* x,
                                      long long n, float* out) {
  for (long long i = 0; i < n; ++i) out[i] = hypot32(y[i], x[i]);
  return 0;
}

extern "C" int solex_canny_atan2f_host(const float* y, const float* x,
                                       long long n, float* out) {
  for (long long i = 0; i < n; ++i) out[i] = atan2f_fd(y[i], x[i]);
  return 0;
}

extern "C" int solex_canny_sector_host(const float* y, const float* x,
                                       long long n, int32_t* out) {
  for (long long i = 0; i < n; ++i) out[i] = sector(y[i], x[i]);
  return 0;
}

// The whole Canny of img (h, w) float32 with the n taps: the magnitude
// (float32) and sector (int32) and the classes before the hysteresis (u8)
// into mag, sec and cls where not null, the edge map (u8 0/1) into out.
extern "C" int solex_canny_host(const float* img, int h, int w,
                                const float* k, int n, float low, float high,
                                float* mag, int32_t* sec, uint8_t* cls,
                                uint8_t* out) {
  if (h < 2 || w < 2 || n < 3 || n > kMaxTaps || n % 2 == 0) return -1;
  const int r = n / 2;
  const size_t hw = (size_t)h * w;
  std::vector<float> v(hw), b(hw), m(hw);
  std::vector<int32_t> s(hw);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      v[(size_t)y * w + x] = blur_chain(k, n, [&](int t) {
        const int yy = y - r + t;
        return yy >= 0 && yy < h ? img[(size_t)yy * w + x] : 0.0f;
      }, false);
    }
  }
  for (int y = 0; y < h; ++y) {
    const float nv = norm_rows(k, n, y, h);
    for (int x = 0; x < w; ++x) {
      const float sum = blur_chain(k, n, [&](int t) {
        const int xx = x - r + t;
        return xx >= 0 && xx < w ? v[(size_t)y * w + xx] : 0.0f;
      }, false);
      b[(size_t)y * w + x] = solex_canny::div(sum, norm_at(k, n, nv, x, w));
    }
  }
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      float p[3][3];
      for (int a = 0; a < 3; ++a) {
        for (int c = 0; c < 3; ++c) {
          p[a][c] = b[(size_t)reflect1(y - 1 + a, h) * w +
                      reflect1(x - 1 + c, w)];
        }
      }
      float dy, dx;
      sobel(p, &dy, &dx);
      m[(size_t)y * w + x] = hypot32(dy, dx);
      s[(size_t)y * w + x] = sector(dy, dx);
    }
  }
  // the state map with a ring of kNone, so that grows() reads no bounds
  const int sw = w + 2;
  std::vector<uint8_t> st((size_t)(h + 2) * sw, kNone);
  auto at = [&](int y, int x) {   // the suppression's zero padding
    return y >= 0 && y < h && x >= 0 && x < w ? m[(size_t)y * w + x] : 0.0f;
  };
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      int dy, dx;
      nms_offset(s[(size_t)y * w + x], &dy, &dx);
      const bool inner = y >= 1 && y <= h - 2 && x >= 1 && x <= w - 2;
      st[(size_t)(y + 1) * sw + x + 1] =
          classify(m[(size_t)y * w + x], at(y + dy, x + dx),
                   at(y - dy, x - dx), inner, low, high);
    }
  }
  if (cls != nullptr) {
    for (int y = 0; y < h; ++y) {
      for (int x = 0; x < w; ++x) {
        cls[(size_t)y * w + x] = st[(size_t)(y + 1) * sw + x + 1];
      }
    }
  }
  for (bool grew = true; grew;) {
    grew = false;
    for (int y = 1; y <= h; ++y) {
      for (int x = 1; x <= w; ++x) {
        const int i = y * sw + x;
        if (st[i] == kWeak && grows(st.data(), i, sw)) {
          st[i] = kReached;
          grew = true;
        }
      }
    }
  }
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      out[(size_t)y * w + x] = st[(size_t)(y + 1) * sw + x + 1] == kReached;
    }
  }
  if (mag != nullptr) std::copy(m.begin(), m.end(), mag);
  if (sec != nullptr) std::copy(s.begin(), s.end(), sec);
  return 0;
}
