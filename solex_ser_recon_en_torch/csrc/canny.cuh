// The device Canny's per-pixel arithmetic (ops/canny.py's twin, step for
// step): the blur's multiply-add chain, the support norm, the Sobel sums,
// the magnitude, fdlibm's atan2f, the sector and the non-maximum
// suppression's decision.  Plain C++17 with no CUDA header: the kernel
// library (nvcc, csrc/canny.cu) and the host library (g++
// -ffp-contract=off, csrc/canny.cpp) both build it, so the CPU tests hold
// the arithmetic the card runs to the twin.
//
// Every float32 operation is written as an explicitly rounded one: on the
// card the _rn intrinsics (never contracted), on the host plain float
// operations (SSE, contraction off) and std::fma.  No flush of subnormals
// on either side (nvcc without -ftz, g++ without -ffast-math).  Constants
// are float32 values of the twin's double literals, rounded once, as
// numpy's float32() rounds them.

#pragma once

#include <stdint.h>
#include <string.h>

#include <cmath>

#ifndef SOLEX_HD
#ifdef __CUDACC__
#define SOLEX_HD __host__ __device__
#else
#define SOLEX_HD
#endif
#endif

namespace solex_canny {

constexpr int kMaxRadius = 8;             // sigma 2.0: 17 taps
constexpr int kMaxTaps = 2 * kMaxRadius + 1;

// states of the class map the gradient kernel writes and the hysteresis
// grows: none, weak (>= low, not yet reached), reached (in the edge map),
// strong below low (seeds its neighbours, never in the map itself)
constexpr uint8_t kNone = 0, kWeak = 1, kReached = 2, kSeed = 3;

SOLEX_HD inline float mul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
SOLEX_HD inline float add(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
SOLEX_HD inline float sub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}
SOLEX_HD inline float div(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}
// a * b + c rounded once
SOLEX_HD inline float fma(float a, float b, float c) {
#ifdef __CUDA_ARCH__
  return __fmaf_rn(a, b, c);
#else
  return std::fma(a, b, c);
#endif
}
// the float32 square root, through float64 as the twin takes it
SOLEX_HD inline float sqrt_f64(float v) {
#ifdef __CUDA_ARCH__
  return (float)__dsqrt_rn((double)v);
#else
  return (float)std::sqrt((double)v);
#endif
}
SOLEX_HD inline int32_t bits(float v) {
#ifdef __CUDA_ARCH__
  return __float_as_int(v);
#else
  int32_t b;
  memcpy(&b, &v, 4);
  return b;
#endif
}
// torch.abs: -0.0 gives +0.0
SOLEX_HD inline float fabs32(float v) {
  return v < 0.0f ? -v : (v == 0.0f ? 0.0f : v);
}

// ---- the blur -------------------------------------------------------------

// x(0) * k[0] + ... + x(n-1) * k[n-1] in XLA:CPU's contraction: fma(x0, k0,
// x1 * k1), then fma(xi, ki, acc); ``plain_centre``: the centre tap's
// product rounded and added (the support norm's second pass).  n >= 3.
// ``x`` is a lambda of the caller's side (host or device).
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class X>
SOLEX_HD inline float blur_chain(const float* k, int n, X x,
                                 bool plain_centre) {
  float acc = fma(x(0), k[0], mul(x(1), k[1]));
  for (int i = 2; i < n; ++i) {
    acc = (plain_centre && i == n / 2) ? add(acc, mul(x(i), k[i]))
                                       : fma(x(i), k[i], acc);
  }
  return acc;
}

// The support norm's first pass at row y of an h-row image: the vertical
// blur of ones, zero outside [0, h).
SOLEX_HD inline float norm_rows(const float* k, int n, int y, int h) {
  const int r = n / 2;
  return blur_chain(k, n, [&](int i) {
    const int yy = y - r + i;
    return (yy >= 0 && yy < h) ? 1.0f : 0.0f;
  }, false);
}

// The support norm at column x of a w-column image, from its row's first
// pass ``nv``, clamped below at 1e-12 as the twin divides by it.
SOLEX_HD inline float norm_at(const float* k, int n, float nv, int x, int w) {
  const int r = n / 2;
  const float v = blur_chain(k, n, [&](int i) {
    const int xx = x - r + i;
    return (xx >= 0 && xx < w) ? nv : 0.0f;
  }, true);
  const float floor = (float)1e-12;
  return v < floor ? floor : v;
}

// ---- the Sobel sums -------------------------------------------------------

// ((0 + k0 * a) + k1 * b) + k2 * c, the twin's order (a -0.0 product comes
// out +0.0 where the twin's does)
SOLEX_HD inline float sum3(float k0, float a, float k1, float b, float k2,
                           float c) {
  return add(add(add(0.0f, mul(k0, a)), mul(k1, b)), mul(k2, c));
}

// d/dy and d/dx of the 3 x 3 neighbourhood p (rows y-1..y+1, columns
// x-1..x+1, reflected at the image's edges): the vertical taps over each
// column, then the horizontal taps over the three column sums.
SOLEX_HD inline void sobel(const float p[3][3], float* gy, float* gx) {
  float ry[3], rx[3];
  for (int c = 0; c < 3; ++c) {
    ry[c] = sum3(-1.0f, p[0][c], 0.0f, p[1][c], 1.0f, p[2][c]);
    rx[c] = sum3(1.0f, p[0][c], 2.0f, p[1][c], 1.0f, p[2][c]);
  }
  *gy = sum3(1.0f, ry[0], 2.0f, ry[1], 1.0f, ry[2]);
  *gx = sum3(-1.0f, rx[0], 0.0f, rx[1], 1.0f, rx[2]);
}

// jnp.hypot as XLA:CPU runs it: hi * sqrt(fma(r, r, 1)), r = lo / hi
SOLEX_HD inline float hypot32(float y, float x) {
  const float ay = fabs32(y), ax = fabs32(x);
  const float hi = ay > ax ? ay : ax, lo = ay > ax ? ax : ay;
  if (hi == 0.0f) return hi;
  const float r = div(lo, hi);
  return mul(hi, sqrt_f64(fma(r, r, 1.0f)));
}

// ---- fdlibm's atan2f (glibc sysdeps/ieee754/flt-32) -----------------------

SOLEX_HD inline float atan_hi(int i) {
  switch (i) {
    case 0: return (float)4.6364760399e-01;
    case 1: return (float)7.8539812565e-01;
    case 2: return (float)9.8279368877e-01;
    default: return (float)1.5707962513e+00;
  }
}
SOLEX_HD inline float atan_lo(int i) {
  switch (i) {
    case 0: return (float)5.0121582440e-09;
    case 1: return (float)3.7748947079e-08;
    case 2: return (float)3.4473217170e-08;
    default: return (float)7.5497894159e-08;
  }
}

// glibc's __atanf
SOLEX_HD inline float atanf_fd(float x) {
  const int32_t ix = bits(x) & 0x7FFFFFFF;
  if (ix < 0x31000000) return x;                       // |x| < 2^-29
  if (ix >= 0x4C000000) {                              // |x| >= 2^25
    const float lim = add(atan_hi(3), atan_lo(3));
    return x > 0.0f ? lim : -lim;
  }
  const bool reduced = ix >= 0x3EE00000;               // |x| >= 0.4375
  const int idx = (ix >= 0x3F300000) + (ix >= 0x3F980000) +
                  (ix >= 0x401C0000);
  const float ax = fabs32(x);
  float xr = x;
  if (reduced) {
    if (idx == 0) {
      xr = div(sub(mul(2.0f, ax), 1.0f), add(ax, 2.0f));
    } else if (idx == 1) {
      xr = div(sub(ax, 1.0f), add(ax, 1.0f));
    } else if (idx == 2) {
      xr = div(sub(ax, 1.5f), add(mul(1.5f, ax), 1.0f));
    } else {
      xr = -div(1.0f, ax);
    }
  }
  const float z = mul(xr, xr), w = mul(z, z);
  const float s1 = mul(z, add((float)3.3333334327e-01, mul(w, add(
      (float)1.4285714924e-01, mul(w, add((float)9.0908870101e-02, mul(w, add(
      (float)6.6610731184e-02, mul(w, add((float)4.9768779427e-02, mul(w,
      (float)1.6285819933e-02)))))))))));
  const float s2 = mul(w, add((float)-2.0000000298e-01, mul(w, add(
      (float)-1.1111110449e-01, mul(w, add((float)-7.6918758452e-02, mul(w,
      add((float)-5.8335702866e-02, mul(w, (float)-3.6531571299e-02)))))))));
  if (!reduced) return sub(xr, mul(xr, add(s1, s2)));
  const float big = sub(atan_hi(idx),
                        sub(sub(mul(xr, add(s1, s2)), atan_lo(idx)), xr));
  return x < 0.0f ? -big : big;
}

// glibc's __ieee754_atan2f for finite y, x, with XLA:CPU's flush of a
// subnormal quotient to zero
SOLEX_HD inline float atan2f_fd(float y, float x) {
  const float pi = (float)3.1415927410e+00, pi_lo = (float)-8.7422776573e-08;
  const float pi_o_2 = (float)1.5707963705e+00, tiny = (float)1.0e-30;
  const int32_t hx = bits(x), hy = bits(y);
  const int32_t ix = hx & 0x7FFFFFFF, iy = hy & 0x7FFFFFFF;
  if (hx == 0x3F800000) return atanf_fd(y);            // x = 1
  const int m = ((hy >> 31) & 1) | ((hx >> 30) & 2);   // 2 sign(x) + sign(y)
  if (iy == 0) {
    if (m < 2) return y;
    const float pi_t = add(pi, tiny);
    return m == 2 ? pi_t : -pi_t;
  }
  if (ix == 0) {
    const float half_pi = add(pi_o_2, tiny);
    return hy < 0 ? -half_pi : half_pi;
  }
  const int32_t k = (iy - ix) >> 23;
  float z;
  if (k > 60) {
    z = add(pi_o_2, mul(0.5f, pi_lo));
  } else if (hx < 0 && k < -60) {
    z = 0.0f;
  } else {
    float q = fabs32(div(y, x));
    if (q < 0x1p-126f) q = 0.0f;                       // subnormal
    z = atanf_fd(q);
  }
  switch (m) {
    case 0: return z;
    case 1: return -z;
    case 2: return sub(pi, sub(z, pi_lo));
    default: return sub(sub(z, pi_lo), pi);
  }
}

// floor((atan2 folded to [0, pi) + pi/8) / (pi/4)) % 4, the quotient's
// floor counted against the exact multiples of float32(pi/4)
SOLEX_HD inline int sector(float gy, float gx) {
  float ang = atan2f_fd(gy, gx);
  if (ang < 0.0f) ang = add(ang, (float)3.141592653589793);
  const double a = (double)add(ang, (float)(3.141592653589793 / 8));
  const double q = (double)(float)(3.141592653589793 / 4);
  const int n = (a >= q) + (a >= 2 * q) + (a >= 3 * q) + (a >= 4 * q);
  return n % 4;
}

// ---- non-maximum suppression and the double threshold ---------------------

// The neighbour (dy, dx) a sector compares with; the other is (-dy, -dx).
SOLEX_HD inline void nms_offset(int s, int* dy, int* dx) {
  *dy = s == 0 ? 0 : 1;
  *dx = s < 2 ? 1 : (s == 2 ? 0 : -1);
}

// The class of a pixel of magnitude m whose sector's neighbours have a and
// b (0 outside the image); ``inner``: not on the image's outer ring.
SOLEX_HD inline uint8_t classify(float m, float a, float b, bool inner,
                                 float low, float high) {
  const bool keep = inner && m >= a && m >= b && m > (float)1e-3;
  const bool lo = keep && m >= low, hi = keep && m >= high;
  return lo ? (hi ? kReached : kWeak) : (hi ? kSeed : kNone);
}

// Whether the weak pixel at s[i] of a state map of row stride ``stride``
// joins the edge map: one of its 8 neighbours is reached or a seed.
SOLEX_HD inline bool grows(const uint8_t* s, int i, int stride) {
  for (int dy = -1; dy <= 1; ++dy) {
    for (int dx = -1; dx <= 1; ++dx) {
      if (s[i + dy * stride + dx] >= kReached) return true;
    }
  }
  return false;
}

// reflect (jnp.pad mode "reflect") an index at most one outside [0, n)
SOLEX_HD inline int reflect1(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

}  // namespace solex_canny
