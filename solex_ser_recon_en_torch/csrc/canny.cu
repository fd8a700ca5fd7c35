// The ellipse fit's Canny edge detector: the flooded downscale's edge map,
// bit for bit the plain twin's (ops/canny.py), in two kernels.
//
// Replaces no Pallas kernel: the JAX package's Canny is XLA
// (solex_ser_recon_en_tpu/ops/canny.py), and the port's plain twin spends
// ~700 elementwise launches a call on it (the float32 steps written out as
// separate ops, the multiply-adds emulated through float64), then syncs the
// host after every hysteresis dilation.  The per-pixel arithmetic is
// csrc/canny.cuh's, which the host library builds too.
//
//   gradient_kernel   one block per 32 x 32 output tile: the image and a
//                     halo of radius + 2 staged in shared memory (zero
//                     outside the image); the vertical, then the horizontal
//                     blur (fma chains, the twin's tap order); the division
//                     by the support norm (computed in place from the
//                     shape); the Sobel sums with reflected borders; the
//                     magnitude and the sector; the non-maximum suppression
//                     against the tile's magnitudes and their one-pixel
//                     ring; the class of each pixel: none, weak, reached
//                     (strong) or seed (strong below the low threshold).
//                     With ``mag``/``sec`` it also writes the magnitude and
//                     the sector (the tests' detail).
//   hysteresis_kernel one round: one block per 64 x 64 tile floods its weak
//                     pixels from its reached and seed pixels and its
//                     one-pixel ring, in shared memory, to the tile's own
//                     fixed point, writes back what it reached and the bool
//                     edge map, and raises the flag with the round's number
//                     when it reached a pixel on its tile's outer ring (the
//                     only pixels other tiles read).  The result is the
//                     set of weak pixels joined to a strong one through
//                     8-connected weak pixels, which no order of the steps
//                     changes; a round in which no outer ring changed ends
//                     it.  The host reads the flag once a round.
//
// What bounds it on an H100: the launches.  The bench scan's 512 x 500
// downscale is 1 MB of float32 in and 0.25 MB of classes out; the blur's
// 2 x 17 taps and the support norm's 17 a pixel are a few thousand
// operations a pixel at most over 256,000 pixels.

#include <cuda_runtime.h>
#include <stdint.h>

#include "canny.cuh"

namespace {

using namespace solex_canny;

constexpr int kThreads = 256;
constexpr int kTile = 32;                    // a gradient block's output
constexpr int kHalo = kMaxRadius + 2;        // the blur's radius, Sobel, NMS
constexpr int kIn = kTile + 2 * kHalo;       // staged input, at most
constexpr int kB = kTile + 4;                // the normalised blur
constexpr int kM = kTile + 2;                // the magnitude
constexpr int kHyst = 64;                    // a hysteresis block's tile
constexpr int kHS = kHyst + 2;               // with its ring

struct Taps {
  float k[kMaxTaps];
};

__device__ __forceinline__ bool inside(int y, int x, int h, int w) {
  return y >= 0 && y < h && x >= 0 && x < w;
}

__global__ void __launch_bounds__(kThreads)
    gradient_kernel(const float* __restrict__ img, int h, int w, Taps taps,
                    int n, float low, float high, uint8_t* __restrict__ cls,
                    float* __restrict__ mag, int32_t* __restrict__ sec,
                    int* __restrict__ flag) {
  __shared__ float s_in[kIn * kIn];
  __shared__ float s_v[kB * kIn];
  __shared__ float s_b[kB * kB];
  __shared__ float s_m[kM * kM];
  __shared__ float s_nv[kB];
  __shared__ float s_k[kMaxTaps];
  __shared__ uint8_t s_sec[kTile * kTile];

  const int tid = threadIdx.x;
  const int halo = n / 2 + 2, nin = kTile + 2 * halo;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  if (tid < n) s_k[tid] = taps.k[tid];
  if (flag != nullptr && tid == 0 && blockIdx.x == 0 && blockIdx.y == 0) {
    *flag = 0;                               // the hysteresis' first round
  }
  for (int i = tid; i < nin * nin; i += kThreads) {
    const int ly = i / nin, lx = i - ly * nin;
    const int gy = y0 - halo + ly, gx = x0 - halo + lx;
    s_in[ly * kIn + lx] =
        inside(gy, gx, h, w) ? img[(size_t)gy * w + gx] : 0.0f;
  }
  __syncthreads();
  for (int i = tid; i < kB; i += kThreads) {
    s_nv[i] = norm_rows(s_k, n, y0 - 2 + i, h);
  }
  // the vertical blur: rows y0 - 2 .. y0 + kTile + 1, every staged column;
  // 0 outside the image (the horizontal pass's zero padding)
  for (int i = tid; i < kB * nin; i += kThreads) {
    const int ly = i / nin, lx = i - ly * nin;
    float v = 0.0f;
    if (inside(y0 - 2 + ly, x0 - halo + lx, h, w)) {
      v = blur_chain(s_k, n, [&](int t) { return s_in[(ly + t) * kIn + lx]; },
                     false);
    }
    s_v[ly * kIn + lx] = v;
  }
  __syncthreads();
  // the horizontal blur over the support norm, inside the image
  for (int i = tid; i < kB * kB; i += kThreads) {
    const int ly = i / kB, lx = i - ly * kB;
    const int gy = y0 - 2 + ly, gx = x0 - 2 + lx;
    float v = 0.0f;
    if (inside(gy, gx, h, w)) {
      const float s = blur_chain(
          s_k, n, [&](int t) { return s_v[ly * kIn + lx + t]; }, false);
      v = solex_canny::div(s, norm_at(s_k, n, s_nv[ly], gx, w));
    }
    s_b[i] = v;
  }
  __syncthreads();
  // the Sobel sums, magnitude and sector: the tile and its ring (0 outside
  // the image, the suppression's zero padding)
  for (int i = tid; i < kM * kM; i += kThreads) {
    const int ly = i / kM, lx = i - ly * kM;
    const int gy = y0 - 1 + ly, gx = x0 - 1 + lx;
    float m = 0.0f;
    if (inside(gy, gx, h, w)) {
      float p[3][3];
      for (int a = 0; a < 3; ++a) {
        const int yy = reflect1(gy - 1 + a, h) - (y0 - 2);
        for (int b = 0; b < 3; ++b) {
          p[a][b] = s_b[yy * kB + reflect1(gx - 1 + b, w) - (x0 - 2)];
        }
      }
      float dy, dx;
      sobel(p, &dy, &dx);
      m = hypot32(dy, dx);
      if (ly >= 1 && ly <= kTile && lx >= 1 && lx <= kTile) {
        const int s = sector(dy, dx);
        s_sec[(ly - 1) * kTile + lx - 1] = (uint8_t)s;
        if (mag != nullptr) {
          mag[(size_t)gy * w + gx] = m;
          sec[(size_t)gy * w + gx] = s;
        }
      }
    }
    s_m[i] = m;
  }
  __syncthreads();
  // non-maximum suppression, the border, the floor and the thresholds
  for (int i = tid; i < kTile * kTile; i += kThreads) {
    const int ly = i / kTile, lx = i - ly * kTile;
    const int gy = y0 + ly, gx = x0 + lx;
    if (!inside(gy, gx, h, w)) continue;
    int dy, dx;
    nms_offset(s_sec[i], &dy, &dx);
    const int c = (ly + 1) * kM + lx + 1;
    const bool inner = gy >= 1 && gy <= h - 2 && gx >= 1 && gx <= w - 2;
    cls[(size_t)gy * w + gx] =
        classify(s_m[c], s_m[c + dy * kM + dx], s_m[c - dy * kM - dx], inner,
                 low, high);
  }
}

__global__ void __launch_bounds__(kThreads)
    hysteresis_kernel(uint8_t* __restrict__ cls, bool* __restrict__ out,
                      int h, int w, int round, int* __restrict__ flag) {
  __shared__ uint8_t s[kHS * kHS];
  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * kHyst, x0 = blockIdx.x * kHyst;
  int weak = 0;
  for (int i = tid; i < kHS * kHS; i += kThreads) {
    const int ly = i / kHS, lx = i - ly * kHS;
    const int gy = y0 - 1 + ly, gx = x0 - 1 + lx;
    const uint8_t v = inside(gy, gx, h, w) ? cls[(size_t)gy * w + gx] : kNone;
    s[i] = v;
    weak |= v == kWeak && ly >= 1 && ly <= kHyst && lx >= 1 && lx <= kHyst;
  }
  // the tile's own fixed point: sweeps until one reaches nothing (a weak
  // pixel read before or after a neighbour's update is right either way:
  // reached pixels only ever grow)
  if (__syncthreads_or(weak)) {
    for (;;) {
      int grew = 0;
      for (int i = tid; i < kHyst * kHyst; i += kThreads) {
        const int c = (i / kHyst + 1) * kHS + i % kHyst + 1;
        if (s[c] == kWeak && grows(s, c, kHS)) {
          s[c] = kReached;
          grew = 1;
        }
      }
      if (!__syncthreads_or(grew)) break;
    }
  }
  int ring = 0;
  for (int i = tid; i < kHyst * kHyst; i += kThreads) {
    const int ly = i / kHyst, lx = i - ly * kHyst;
    const int gy = y0 + ly, gx = x0 + lx;
    if (!inside(gy, gx, h, w)) continue;
    const size_t g = (size_t)gy * w + gx;
    const uint8_t v = s[(ly + 1) * kHS + lx + 1];
    if (v == kReached && cls[g] == kWeak) {
      cls[g] = kReached;
      ring |= ly == 0 || lx == 0 || ly == kHyst - 1 || lx == kHyst - 1;
    }
    out[g] = v == kReached;
  }
  if (__syncthreads_or(ring) && tid == 0) *flag = round;
}

dim3 grid_of(int h, int w, int tile) {
  return dim3((w + tile - 1) / tile, (h + tile - 1) / tile);
}

}  // namespace

extern "C" int solex_canny_max_radius() { return kMaxRadius; }

// img: (h, w) C-contiguous float32; taps: n host floats (3 <= n <= 2 *
// kMaxRadius + 1, odd); low, high: the float32 thresholds; cls: (h, w) u8,
// the classes out; mag (float32) and sec (int32), both (h, w) or both
// null: the magnitude and sector out; flag: one device int, zeroed for
// solex_canny_hysteresis (or null).
extern "C" int solex_canny_gradients(const float* img, int h, int w,
                                     const float* taps, int n, float low,
                                     float high, uint8_t* cls, float* mag,
                                     int32_t* sec, int* flag, void* stream) {
  if (h < 2 || w < 2 || n < 3 || n > kMaxTaps || n % 2 == 0 ||
      (mag == nullptr) != (sec == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Taps t{};
  for (int i = 0; i < n; ++i) t.k[i] = taps[i];
  gradient_kernel<<<grid_of(h, w, kTile), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      img, h, w, t, n, low, high, cls, mag, sec, flag);
  return (int)cudaGetLastError();
}

// The hysteresis on the classes ``cls`` (h, w) u8 of solex_canny_gradients,
// whose ``flag`` it was given: rounds until no tile's outer ring changed,
// the flag read back after each (the stream synchronised); out: (h, w)
// bool, the edge map; *rounds: the rounds run.
extern "C" int solex_canny_hysteresis(uint8_t* cls, bool* out, int h, int w,
                                      int* flag, int* rounds, void* stream) {
  if (h < 2 || w < 2 || flag == nullptr || rounds == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *rounds = 0;
  for (int r = 1;; ++r) {
    hysteresis_kernel<<<grid_of(h, w, kHyst), kThreads, 0, st>>>(cls, out, h,
                                                                 w, r, flag);
    cudaError_t e = cudaGetLastError();
    int seen = 0;
    if (e == cudaSuccess) {
      e = cudaMemcpyAsync(&seen, flag, sizeof(int), cudaMemcpyDeviceToHost,
                          st);
    }
    if (e == cudaSuccess) e = cudaStreamSynchronize(st);
    if (e != cudaSuccess) return (int)e;
    *rounds = r;
    if (seen != r) return 0;
  }
}
