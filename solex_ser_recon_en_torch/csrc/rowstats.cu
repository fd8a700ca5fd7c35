// The transversalium row statistics: per row of the circularised frame, the
// mean and the MAD-rejected mean of the log ratio of that row to the row
// above, over the row's chord of the fitted solar circle.
//
// Replaces no Pallas kernel: the JAX package sorts every masked row with
// jnp.sort (solex_ser_recon_en_tpu/ops/rowstats.py:24), and the port's
// plain twin (ops/rowstats.py: strip_mask + row_log_ratio_stats) sorts
// every row twice with torch.sort and spends ~95 more launches on the mask
// and the elementwise steps.  This kernel gives the same numbers, the chord
// bounds, medians, MADs and kept counts bit for bit, from one launch.
//
//   chord   [x_lo, x_hi) and row_ok from the seven float32 geometry scalars
//           with strip_mask's float32 operations in its order (ceil,
//           floor, sqrtf, maximum, minimum; no contraction: --fmad=false)
//   rat[j]  = logf(f[y, x] / f[y - 1, x]) over the chord, row 0 against
//           itself: IEEE division and logf, as torch's CUDA div and log
//   med     = 0.5f * (s[(n-1)/2] + s[n/2]), s the twin's sorted row: the
//           chord's values with the W - n columns outside it as +inf
//   mdev    = the same of |rat - med|
//   keep    = (mdev > 0 ? |rat - med| / max(mdev, 1e-30f) : 0) < 2
//   mean_all, mean_r = the chord's and the kept values' float32 sums over
//           their counts (0 where the count is 0)
//
// Design:
// - One block per row, all H rows; a row with an empty chord writes 0 and
//   leaves, as the twin's n = 0 branch gives.
// - rat is staged once in shared memory (dynamic, sized from the row
//   width); rows wider than kStageFloats stage in a global workspace the
//   caller passes instead.
// - Order statistics by selection, not sorting.  Floats map to
//   order-preserving uint32 keys (the sign flip of torch's radix sort, so
//   -0.0 comes before +0.0), every NaN to 0xFFFFFFFF.  The columns outside
//   the chord are never stored: the twin's sorted row is
//   [chord non-NaN][W - n padding +inf][chord NaN], so a rank past the
//   chord's non-NaN values resolves to +inf or NaN by that layout, and a
//   rank inside them is an 8-bit-digit radix select over the stored keys:
//   4 passes of a 256-bin shared histogram (shared atomics; the median's
//   first pass rides on the pass that forms rat), then the neighbouring
//   rank of an even count from the last pass's counts or one min pass.
// - Sums in a fixed order (a thread's strided values, a warp's xor tree,
//   the warps in order), no atomics: two launches give the same bits.
//
// What bounds it on an H100: bytes in principle, the chords' u16 pixels
// read once (at most the band's rows, 2048 x 2204 x 2 B, ~9 MB, ~3 us at
// 3.35 TB/s); in practice the selection's passes over shared memory (11
// passes of the chord a row).  128 threads a block ran 19% faster than 256
// and as fast as 64 (fewer threads share each pass's scan and barriers).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;                  // an 8-bit digit
constexpr int kBinsPer = kBins / kThreads;  // bins a thread scans
constexpr int kStageFloats = 8192;  // widest row staged in shared memory
constexpr uint32_t kNanKey = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Geometry {
  float cx, cy, r, bx0, by1, bx2, by3;
};

struct Shared {
  uint32_t hist[kBins];
  float fsum[kWarps];
  uint32_t usum[kWarps];
  uint32_t bin, below, count;  // the selected bin of a pass
};

// torch.maximum / torch.minimum / torch.clamp on float32 (NaN propagates)
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ uint32_t fkey(float v) {
  const uint32_t u = __float_as_uint(v);
  if (v != v) return kNanKey;
  return u ^ ((u & 0x80000000u) ? 0xFFFFFFFFu : 0x80000000u);
}

__device__ __forceinline__ float unkey(uint32_t k) {
  return __uint_as_float(k ^ ((k & 0x80000000u) ? 0x80000000u : 0xFFFFFFFFu));
}

// block-wide sums and minimum in a fixed order; every thread gets the result
__device__ float block_sum(float v, Shared& sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh.fsum[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = sh.fsum[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s += sh.fsum[w];
  return s;
}

__device__ uint32_t block_count(uint32_t v, Shared& sh) {
  v = __reduce_add_sync(kFull, v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh.usum[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += sh.usum[w];
  return s;
}

__device__ uint32_t block_min(uint32_t v, Shared& sh) {
  v = __reduce_min_sync(kFull, v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh.usum[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t m = sh.usum[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = min(m, sh.usum[w]);
  return m;
}

// the values whose order statistics a select reads: rat itself, or its
// distance from the median
struct Identity {
  __device__ __forceinline__ float operator()(float x) const { return x; }
};
struct Distance {
  float med;
  __device__ __forceinline__ float operator()(float x) const {
    return fabsf(x - med);
  }
};

__device__ __forceinline__ void clear_bins(Shared& sh) {
#pragma unroll
  for (int i = 0; i < kBinsPer; ++i) sh.hist[kBinsPer * threadIdx.x + i] = 0;
}

// Counts the top digit of every non-NaN key (a select's first pass).
__device__ __forceinline__ void count_top(Shared& sh, uint32_t key) {
  if (key != kNanKey) atomicAdd(&sh.hist[key >> 24], 1u);
}

// The k-th smallest (from 0) of the non-NaN keys of f(stage[0..n)), which
// must hold more than k of them.  *le: how many of those keys are <= it.
// top_counted: the caller has zeroed the bins and counted the top digits
// (count_top) since its last barrier.
template <typename F>
__device__ uint32_t select_key(const float* stage, int n, uint32_t k, F f,
                               Shared& sh, uint32_t* le, bool top_counted) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t prefix = 0, mask = 0, below = 0, count = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (shift < 24 || !top_counted) {
      clear_bins(sh);
      __syncthreads();
      for (int j = threadIdx.x; j < n; j += kThreads) {
        const uint32_t key = fkey(f(stage[j]));
        if (key != kNanKey && (key & mask) == prefix) {
          atomicAdd(&sh.hist[(key >> shift) & 0xFFu], 1u);
        }
      }
    }
    __syncthreads();
    // scan of the bins, kBinsPer consecutive ones a thread
    uint32_t c[kBinsPer], mine = 0;
#pragma unroll
    for (int i = 0; i < kBinsPer; ++i) {
      c[i] = sh.hist[kBinsPer * threadIdx.x + i];
      mine += c[i];
    }
    uint32_t incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t up = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += up;
    }
    if (lane == 31) sh.usum[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) incl += sh.usum[w];
    const uint32_t want = k - below;
    uint32_t before = incl - mine;  // keys in the bins below this thread's
#pragma unroll
    for (int i = 0; i < kBinsPer; ++i) {
      if (before <= want && want < before + c[i]) {
        sh.bin = kBinsPer * threadIdx.x + i;
        sh.below = before;
        sh.count = c[i];
      }
      before += c[i];
    }
    __syncthreads();
    prefix |= sh.bin << shift;
    mask |= 0xFFu << shift;
    below += sh.below;
    count = sh.count;
    __syncthreads();  // sh.bin and the bins are rewritten by the next pass
  }
  *le = below + count;
  return prefix;
}

// 0.5f * (s[(n-1)/2] + s[n/2]) of the twin's sorted row of f(stage[j]):
// the n chord values and the W - n padding +inf, NaN last.  finite: how
// many f(stage[j]) are not NaN; top_counted as for select_key.
template <typename F>
__device__ float masked_median(const float* stage, int n, int W, F f,
                               uint32_t finite, Shared& sh,
                               bool top_counted) {
  const float inf = __uint_as_float(0x7F800000u);
  const float nan = __uint_as_float(0x7FFFFFFFu);
  const uint32_t lo_i = (uint32_t)(n - 1) / 2, hi_i = (uint32_t)n / 2;
  // a rank past the non-NaN values: the padding, then the NaNs
  auto layout = [&](uint32_t i) {
    return i - finite < (uint32_t)(W - n) ? inf : nan;
  };
  float lo, hi;
  if (lo_i < finite) {
    uint32_t le;
    const uint32_t key = select_key(stage, n, lo_i, f, sh, &le, top_counted);
    lo = unkey(key);
    if (hi_i < le) {
      hi = lo;
    } else if (hi_i < finite) {  // the least key above
      uint32_t m = kNanKey;
      for (int j = threadIdx.x; j < n; j += kThreads) {
        const uint32_t kj = fkey(f(stage[j]));
        if (kj > key && kj < m) m = kj;
      }
      hi = unkey(block_min(m, sh));
    } else {
      hi = layout(hi_i);
    }
  } else {
    lo = layout(lo_i);
    hi = layout(hi_i);
  }
  return 0.5f * (lo + hi);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    row_stats_kernel(const T* __restrict__ img, int H, int W, Geometry g,
                     float* __restrict__ mean_all, float* __restrict__ mean_r,
                     float* __restrict__ workspace,
                     int32_t* __restrict__ dbg_i, float* __restrict__ dbg_f) {
  extern __shared__ float smem[];
  __shared__ Shared sh;
  const int y = blockIdx.x;

  // the chord: strip_mask's float32 steps (ops/rowstats.py)
  const float yf = (float)y;
  const float y1 = ceilf(tmax(g.cy - g.r, g.by1));
  const float y2 = floorf(tmin(g.cy + g.r, g.by3));
  const float t = yf - g.cy;
  const float d2 = g.r * g.r - t * t;
  const float dx = floorf(sqrtf(tmax(d2, 0.0f)));
  const float x_lo = ceilf(tmax(g.cx - dx, g.bx0));
  const float x_hi = floorf(tmin(g.cx + dx, g.bx2));
  const bool row_ok = (yf > y1) & (yf < y2) & (d2 >= 0.0f);
  const float wf = (float)W;
  const int lo = (int)fminf(fmaxf(x_lo, 0.0f), wf);
  const int hi = (int)fminf(fmaxf(x_hi, 0.0f), wf);
  const int n = row_ok && hi > lo ? hi - lo : 0;

  float med = 0.0f, mdev = 0.0f, all = 0.0f, kept = 0.0f;
  uint32_t nk = 0;
  if (n > 0) {
    float* stage = W <= kStageFloats ? smem : workspace + (size_t)y * W;
    const T* cur = img + (size_t)y * W + lo;
    const T* prev = img + (size_t)(y > 0 ? y - 1 : 0) * W + lo;
    // the log ratio, its sum, its non-NaN count and the median's first
    // histogram in one pass
    clear_bins(sh);
    __syncthreads();
    float s = 0.0f;
    uint32_t finite = 0;
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float r = logf(__fdiv_rn((float)cur[j], (float)prev[j]));
      stage[j] = r;
      s += r;
      const uint32_t key = fkey(r);
      finite += key != kNanKey;
      count_top(sh, key);
    }
    all = block_sum(s, sh) / (float)n;  // its barriers publish the stage
    finite = block_count(finite, sh);

    med = masked_median(stage, n, W, Identity{}, finite, sh, true);
    // |rat - med| is NaN where rat is, and everywhere else only where med
    // is not finite
    if (!isfinite(med)) {
      uint32_t mine = 0;
      for (int j = threadIdx.x; j < n; j += kThreads) {
        mine += fabsf(stage[j] - med) == fabsf(stage[j] - med);
      }
      finite = block_count(mine, sh);
    }
    mdev = masked_median(stage, n, W, Distance{med}, finite, sh, false);

    const float mden = tmax(mdev, 1e-30f);
    float ks = 0.0f;
    uint32_t kc = 0;
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float r = stage[j];
      const float d = fabsf(r - med);
      const float sc = mdev > 0.0f ? __fdiv_rn(d, mden) : 0.0f;
      if (sc < 2.0f) {
        ks += r;
        ++kc;
      }
    }
    const float total = block_sum(ks, sh);
    nk = block_count(kc, sh);
    kept = nk > 0 ? total / (float)nk : 0.0f;
  }
  if (threadIdx.x == 0) {
    mean_all[y] = all;
    mean_r[y] = kept;
    if (dbg_i) {
      dbg_i[4 * y] = lo;
      dbg_i[4 * y + 1] = hi;
      dbg_i[4 * y + 2] = row_ok;
      dbg_i[4 * y + 3] = (int32_t)nk;
      dbg_f[2 * y] = med;
      dbg_f[2 * y + 1] = mdev;
    }
  }
}

template <typename T>
int launch(const void* img, int H, int W, Geometry g, float* mean_all,
           float* mean_r, float* workspace, int32_t* dbg_i, float* dbg_f,
           cudaStream_t st) {
  const size_t smem = W <= kStageFloats ? (size_t)W * sizeof(float) : 0;
  row_stats_kernel<T><<<H, kThreads, smem, st>>>(
      static_cast<const T*>(img), H, W, g, mean_all, mean_r, workspace,
      dbg_i, dbg_f);
  return (int)cudaGetLastError();
}

}  // namespace

// The widest row the kernel stages in shared memory; wider rows need the
// (H, W) float32 workspace.
extern "C" int solex_row_stats_stage_floats() { return kStageFloats; }

// img: (H, W) C-contiguous u16 (elem_bytes 2) or float32 (4); the geometry
// as float32 scalars; mean_all, mean_r: (H,) float32; workspace: (H, W)
// float32 where W > kStageFloats, else unused; dbg_i (H, 4) int32 (x_lo,
// x_hi clipped to [0, W], row_ok, kept count) and dbg_f (H, 2) float32
// (median, MAD) where not null.
extern "C" int solex_row_stats(const void* img, int elem_bytes, int H, int W,
                               float cx, float cy, float r, float bx0,
                               float by1, float bx2, float by3,
                               float* mean_all, float* mean_r,
                               float* workspace, int32_t* dbg_i, float* dbg_f,
                               void* stream) {
  if (H <= 0 || W <= 0 || (W > kStageFloats && !workspace) ||
      (!dbg_i) != (!dbg_f)) {
    return (int)cudaErrorInvalidValue;
  }
  const Geometry g{cx, cy, r, bx0, by1, bx2, by3};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    return launch<uint16_t>(img, H, W, g, mean_all, mean_r, workspace, dbg_i,
                            dbg_f, st);
  }
  if (elem_bytes == 4) {
    return launch<float>(img, H, W, g, mean_all, mean_r, workspace, dbg_i,
                         dbg_f, st);
  }
  return (int)cudaErrorInvalidValue;
}
