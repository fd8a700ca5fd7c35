// The product chain's per-pixel and per-bin arithmetic (pipeline/products.py
// and ops/clahe.py's twin, step for step): the transversalium row gain,
// CLAHE's clip and redistribution, its LUT levels, the tile coordinates and
// weights of the bilinear blend and the blend itself, the percentile's
// lerp, the three stretches' limits and the stretch.  Plain C++17 with no
// CUDA header: the kernel library (nvcc, csrc/products.cu) and the host
// library (g++ -ffp-contract=off, csrc/products.cpp) both build it, so the
// CPU tests hold the arithmetic the card runs to the twin.
//
// Every float32 operation is written as an explicitly rounded one: on the
// card the _rn intrinsics (never contracted), on the host plain float
// operations (SSE, contraction off).  The twin runs on the CPU, where torch
// divides by a host scalar truly (its CUDA path multiplies by the
// reciprocal): here every division is a true one.  Integer steps are exact
// int32, as the twin's.

#pragma once

#include <stdint.h>

#include <cmath>

#ifndef SOLEX_HD
#ifdef __CUDACC__
#define SOLEX_HD __host__ __device__
#else
#define SOLEX_HD
#endif
#endif

namespace solex_products {

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
// an int32 as float32, rounded to nearest (exact below 2^24)
SOLEX_HD inline float f32(int32_t v) {
#ifdef __CUDA_ARCH__
  return __int2float_rn(v);
#else
  return (float)v;
#endif
}
// a pixel as float32: u8 and u16 exactly, float32 as it is
template <typename T>
SOLEX_HD inline float value_f32(T v) {
  if constexpr (sizeof(T) == 4) {
    return v;
  } else {
    return f32((int32_t)v);
  }
}
// torch.round: to nearest, ties to even
SOLEX_HD inline float round_even(float v) {
#ifdef __CUDA_ARCH__
  return rintf(v);
#else
  return std::nearbyint(v);
#endif
}
SOLEX_HD inline float floor32(float v) {
#ifdef __CUDA_ARCH__
  return floorf(v);
#else
  return std::floor(v);
#endif
}

// torch.clamp(x, 0, 65535) then to_u16's int32 cast (truncation).  NaN
// gives 0 on both of the twin's devices (x86's int32 cast of NaN is
// INT_MIN, whose low 16 bits are 0; CUDA's cast gives 0).
SOLEX_HD inline uint16_t sat_u16(float x) {
  if (!(x > 0.0f)) return 0;
  if (x >= 65535.0f) return 65535;
  return (uint16_t)(int32_t)x;
}

// apply_row_gain: u16(trunc(clamp(f32(v) * gain[y], 0, 65535)))
SOLEX_HD inline uint16_t gain_px(float v, float g) {
  return sat_u16(mul(v, g));
}

// _clip_redistribute's per-tile plan from the tile's excess over the clip
// (the sum of max(h - clip, 0)): the uniform batch ``redist``, the
// ``residual`` bins that get one more, every ``step``-th from bin 0.
struct Clip {
  int32_t clip, redist, residual, step;
};

// clip <= 0: no clipping (the twin skips _clip_redistribute)
SOLEX_HD inline Clip clip_plan(int32_t clip, int32_t excess,
                               int32_t hist_size) {
  Clip c{clip, 0, 0, hist_size};
  if (clip <= 0) return c;
  c.redist = excess / hist_size;  // excess >= 0: floor
  c.residual = excess - c.redist * hist_size;
  const int32_t r = c.residual > 1 ? c.residual : 1;
  c.step = hist_size / r > 1 ? hist_size / r : 1;
  return c;
}
SOLEX_HD inline int32_t excess_of(int32_t h, int32_t clip) {
  return clip > 0 && h > clip ? h - clip : 0;
}
// bin i of the clipped, redistributed histogram
SOLEX_HD inline int32_t clipped_bin(int32_t h, int32_t i, const Clip& c) {
  if (c.clip <= 0) return h;
  const int32_t bonus = i % c.step == 0 && i / c.step < c.residual;
  return (h < c.clip ? h : c.clip) + c.redist + bonus;
}
// a LUT level: clamp(round(f32(cdf) * lut_scale), 0, hist_size - 1)
SOLEX_HD inline int32_t lut_level(int32_t cdf, float scale,
                                  int32_t hist_size) {
  const float v = round_even(mul(f32(cdf), scale));
  if (!(v > 0.0f)) return 0;
  const float top = f32(hist_size - 1);
  return v >= top ? hist_size - 1 : (int32_t)v;
}

// One axis of the blend at pixel coordinate x: the two tiles (t1, t2) and
// the twin's weights w1 = 1 - a and w2 = 1 - w1 of t = x / tile - 0.5,
// a = t - floor(t).
struct Axis {
  int32_t t1, t2;
  float w1, w2;
};
SOLEX_HD inline Axis axis_at(int32_t x, int32_t tile, int32_t tiles) {
  const float t = sub(div(f32(x), f32(tile)), 0.5f);
  const int32_t t1 = (int32_t)floor32(t);
  const float a = sub(t, f32(t1));
  Axis r;
  r.t2 = t1 + 1 < tiles - 1 ? t1 + 1 : tiles - 1;
  r.t1 = t1 > 0 ? t1 : 0;
  r.w1 = sub(1.0f, a);
  r.w2 = sub(1.0f, r.w1);
  return r;
}
// the twin's sum, in its order: l11 wx1 wy1 + l12 (1-wx1) wy1 + l21 wx1
// (1-wy1) + l22 (1-wx1) (1-wy1), each product left to right; then round,
// clamp to [0, hist_size - 1]
SOLEX_HD inline int32_t blend_level(int32_t l11, int32_t l12, int32_t l21,
                                    int32_t l22, const Axis& ax,
                                    const Axis& ay, int32_t hist_size) {
  float s = mul(mul(f32(l11), ax.w1), ay.w1);
  s = add(s, mul(mul(f32(l12), ax.w2), ay.w1));
  s = add(s, mul(mul(f32(l21), ax.w1), ay.w2));
  s = add(s, mul(mul(f32(l22), ax.w2), ay.w2));
  const float v = round_even(s);
  if (!(v > 0.0f)) return 0;
  const float top = f32(hist_size - 1);
  return v >= top ? hist_size - 1 : (int32_t)v;
}

// percentile_from_hist's lerp of the two order statistics s0, s1
SOLEX_HD inline float lerp_taps(int32_t s0, int32_t s1, float low_w,
                                float high_w) {
  return add(mul(f32(s0), low_w), mul(f32(s1), high_w));
}

// the stretches' limits (lo, hi): the CLAHE image's between its 10th
// percentile ``dark`` and max(its maximum, dark + 1); the high-contrast
// image's between bright / 4 and bright, and the protus image's between 0
// and max(0.18 bright, 1), bright = max(the disk's 99.9999th percentile, 1)
struct Limits {
  float lo, hi;
};
SOLEX_HD inline float max32(float a, float b) { return a > b ? a : b; }
SOLEX_HD inline Limits cc_limits(float dark, int32_t top) {
  return Limits{dark, max32(f32(top), add(dark, 1.0f))};
}
SOLEX_HD inline float bright_of(float pct) { return max32(pct, 1.0f); }
SOLEX_HD inline Limits hc_limits(float bright) {
  return Limits{mul(bright, 0.25f), bright};
}
// 0.18 as the twin's float32 tensor takes a host double: rounded once
SOLEX_HD inline Limits protus_limits(float bright) {
  return Limits{0.0f, max32(mul(bright, (float)0.18), 1.0f)};
}
// _stretch: trunc(clamp(65535 (v - lo) / (hi - lo), 0, 65535))
SOLEX_HD inline uint16_t stretch_px(float v, const Limits& l) {
  return sat_u16(div(mul(65535.0f, sub(v, l.lo)), sub(l.hi, l.lo)));
}

}  // namespace solex_products
