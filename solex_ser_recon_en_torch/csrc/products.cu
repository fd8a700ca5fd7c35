// The product chain of one corrected disk: the transversalium row gain,
// CLAHE's LUTs and bilinear blend, and the percentile stretches, bit for bit
// the plain twin's (pipeline/products.py, ops/clahe.py, ops/rowstats.py) as
// it runs on the CPU, in five kernels around kernel B5 (csrc/hist.cu).
//
// Replaces no Pallas kernel: the JAX package leaves this chain to XLA
// (solex_ser_recon_en_tpu/pipeline/products.py, ops/clahe.py), and the
// port's twin spends ~130 small torch launches a product on it: ~7 passes
// for the gain, ~35 ops for the clip, redistribution, cumsum and LUT, ~20
// for the coordinate vectors, four lookups that each build two int64
// full-image index tensors, ~15 float32 passes for the blend and ~12 for
// the percentiles and stretches.  The per-pixel and per-bin arithmetic is
// csrc/products.cuh's, which the host library builds too.
//
//   row_gain_kernel       u16(trunc(clamp(f32(v) * gain[y], 0, 65535))),
//                         eight pixels a thread, in one pass
//   clahe_lut_kernel      a cluster of blocks a tile (8 of 8192 bins for
//                         65536 bins, one block for 256): each thread holds
//                         8 bins in registers; the tile's excess over the
//                         clip summed over the cluster (distributed shared
//                         memory), the exact int32 clip and redistribution,
//                         the inclusive cumsum (a block scan, the lower
//                         blocks' totals read from the cluster) and the LUT
//                         levels as u16; more blocks, when asked, sum the
//                         tiles' histograms into the whole image's
//   clahe_blend_kernel    four pixels of a row a thread: the tile
//                         coordinates and weights from the pixel's x and y
//                         in registers (true divisions), the four LUT
//                         gathers (the LUTs, 4 x 65536 x 2 B, stay in L2),
//                         the twin's sum in its order, round and clamp
//   stretch_params_kernel a cluster of 8 blocks a 65536-bin histogram,
//                         each thread 8 bins in registers: the order
//                         statistics (a block scan, the lower blocks'
//                         totals from the cluster, the crossing found
//                         among the thread's bins), the lerp, the CLAHE
//                         image's maximum as its highest non-empty bin,
//                         and the stretches' limits, into six floats
//   stretch_kernel        eight pixels a thread: the CLAHE image's stretch
//                         and, when asked, the disk's high-contrast and
//                         protus stretches from one read of each image
//
// What bounds it on an H100: bytes.  The bench product is 2048 x 2204 u16
// (9.0 MB): the gain reads and writes it once, the blend reads it and
// writes the CLAHE image, the stretch reads the CLAHE image and writes its
// stretch (and reads the disk once more and writes two stretches in the
// default mode): ~54 MB, ~16 us at 3.35 TB/s, with kernel B5's two reads
// besides.  The LUT and parameter steps read 1-2 MB of histograms from L2.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "products.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace solex_products;

constexpr int kPixThreads = 256;   // the elementwise kernels' blocks
constexpr int kGainPix = 8;        // pixels a thread: the gain, the stretch
constexpr int kBlendPix = 4;       // pixels a thread: the blend
constexpr int kBinThreads = 1024;  // the histogram kernels' blocks
constexpr int kThreadBins = 8;     // bins a thread
constexpr int kBlockBins = kBinThreads * kThreadBins;  // bins a block
constexpr int kMaxCluster = 8;     // blocks a 65536-bin histogram

// inclusive scan of v over the block; *total gets the block's sum.  Every
// thread of the block calls it; s_warp holds 32 ints.
template <int kThreads>
__device__ int block_scan(int v, int* s_warp, int* total) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    s_warp[lane] = s;
  }
  __syncthreads();
  const int before = warp > 0 ? s_warp[warp - 1] : 0;
  *total = s_warp[kWarps - 1];
  __syncthreads();  // s_warp free for the next call
  return before + x;
}

// n values of T from p, 16-byte (8-byte for 8 bytes) aligned
template <typename T, int N>
__device__ inline void load_vec(const T* p, T (&v)[N]) {
  constexpr int kBytes = (int)sizeof(T) * N;
  if constexpr (kBytes == 4) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    memcpy(v, &u, 4);
  } else if constexpr (kBytes == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    memcpy(v, &u, 8);
  } else {
    static_assert(kBytes % 16 == 0, "16-byte pieces");
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      memcpy(reinterpret_cast<char*>(v) + 16 * i, &u, 16);
    }
  }
}

template <typename T, int N>
__device__ inline void store_vec(T* p, const T (&v)[N]) {
  constexpr int kBytes = (int)sizeof(T) * N;
  if constexpr (kBytes == 4) {
    uint32_t u;
    memcpy(&u, v, 4);
    *reinterpret_cast<uint32_t*>(p) = u;
  } else if constexpr (kBytes == 8) {
    uint2 u;
    memcpy(&u, v, 8);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
    static_assert(kBytes % 16 == 0, "16-byte pieces");
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      uint4 u;
      memcpy(&u, reinterpret_cast<const char*>(v) + 16 * i, 16);
      reinterpret_cast<uint4*>(p)[i] = u;
    }
  }
}

__host__ __device__ inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// ---- the row gain ----------------------------------------------------------

// vec: img and out aligned for eight pixels (the flat index is a multiple
// of eight, so every thread's run is)
template <typename T>
__global__ void __launch_bounds__(kPixThreads)
row_gain_kernel(const T* __restrict__ img, const float* __restrict__ gain,
                int w, long long n, uint16_t* __restrict__ out, bool vec) {
  const long long i0 =
      ((long long)blockIdx.x * kPixThreads + threadIdx.x) * kGainPix;
  if (i0 >= n) return;
  long long y = i0 / w;
  int x = (int)(i0 - y * w);
  float g = gain[y];
  T v[kGainPix];
  uint16_t o[kGainPix];
  const bool full = vec && i0 + kGainPix <= n;
  if (full) {
    load_vec(img + i0, v);
  } else {
#pragma unroll
    for (int k = 0; k < kGainPix; ++k) v[k] = i0 + k < n ? img[i0 + k] : T(0);
  }
#pragma unroll
  for (int k = 0; k < kGainPix; ++k) {
    if (i0 + k >= n) break;
    if (x == w) {  // the run crosses into the next row
      x = 0;
      g = gain[++y];
    }
    o[k] = gain_px(value_f32(v[k]), g);
    ++x;
  }
  if (full) {
    store_vec(out + i0, o);
  } else {
    for (int k = 0; k < kGainPix && i0 + k < n; ++k) out[i0 + k] = o[k];
  }
}

template <typename T>
int launch_row_gain(const void* img, int h, int w, const float* gain,
                    uint16_t* out, cudaStream_t st) {
  const long long n = (long long)h * w;
  const bool vec = aligned(img, 16) && aligned(out, 16);
  const long long threads = (n + kGainPix - 1) / kGainPix;
  const unsigned blocks = (unsigned)((threads + kPixThreads - 1) / kPixThreads);
  row_gain_kernel<T><<<blocks, kPixThreads, 0, st>>>(
      static_cast<const T*>(img), gain, w, n, out, vec);
  return (int)cudaGetLastError();
}

// ---- CLAHE's LUTs ----------------------------------------------------------

// grid: tiles x CS blocks (clusters of CS along x), then whole clusters of
// blocks that sum the tiles' histograms into ``full`` (when not null)
template <int CS>
__global__ void __launch_bounds__(kBinThreads)
clahe_lut_kernel(const int32_t* __restrict__ hist, int tiles, int hist_size,
                 int clip, float scale, uint16_t* __restrict__ lut,
                 int32_t* __restrict__ full) {
  __shared__ int s_warp[32];
  __shared__ int s_part[2];  // this block's excess and clipped-bin sum
  const int tile = blockIdx.x / CS;
  if (tile >= tiles) {  // whole clusters: no cluster barrier is skipped
    const int b0 = (blockIdx.x - tiles * CS) * kBlockBins +
                   threadIdx.x * kThreadBins;
    for (int b = b0; b < b0 + kThreadBins && b < hist_size; ++b) {
      int s = 0;
      for (int t = 0; t < tiles; ++t) s += hist[(size_t)t * hist_size + b];
      full[b] = s;
    }
    return;
  }
  const int rank = blockIdx.x % CS;
  const int span = (hist_size + CS - 1) / CS;
  const int lo = rank * span;
  const int hi = lo + span < hist_size ? lo + span : hist_size;
  const int b0 = lo + threadIdx.x * kThreadBins;
  const int32_t* ht = hist + (size_t)tile * hist_size;
  const bool vec = b0 + kThreadBins <= hi && aligned(ht + b0, 16);
  int32_t h[kThreadBins];
  if (vec) {
    load_vec(ht + b0, h);
  } else {
#pragma unroll
    for (int k = 0; k < kThreadBins; ++k) h[k] = b0 + k < hi ? ht[b0 + k] : 0;
  }

  int ex = 0;
#pragma unroll
  for (int k = 0; k < kThreadBins; ++k) ex += excess_of(h[k], clip);
  int total;
  block_scan<kBinThreads>(ex, s_warp, &total);
  if constexpr (CS > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) s_part[0] = total;
    cluster.sync();
    total = 0;
    for (int r = 0; r < CS; ++r) total += cluster.map_shared_rank(s_part, r)[0];
  }
  const Clip c = clip_plan(clip, total, hist_size);

  int v[kThreadBins];
  int s = 0;
#pragma unroll
  for (int k = 0; k < kThreadBins; ++k) {
    v[k] = b0 + k < hi ? clipped_bin(h[k], b0 + k, c) : 0;
    s += v[k];
  }
  int btotal;
  int cdf = block_scan<kBinThreads>(s, s_warp, &btotal) - s;
  if constexpr (CS > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) s_part[1] = btotal;
    cluster.sync();
    for (int r = 0; r < rank; ++r) cdf += cluster.map_shared_rank(s_part, r)[1];
  }
  uint16_t o[kThreadBins];
#pragma unroll
  for (int k = 0; k < kThreadBins; ++k) {
    cdf += v[k];
    o[k] = (uint16_t)lut_level(cdf, scale, hist_size);
  }
  uint16_t* lt = lut + (size_t)tile * hist_size;
  if (vec && aligned(lt + b0, 16)) {
    store_vec(lt + b0, o);
  } else {
    for (int k = 0; k < kThreadBins && b0 + k < hi; ++k) lt[b0 + k] = o[k];
  }
  if constexpr (CS > 1) {
    cg::this_cluster().sync();  // no block leaves while its peers read it
  }
}

template <int CS>
int launch_clahe_lut(const int32_t* hist, int tiles, int hist_size, int clip,
                     float scale, uint16_t* lut, int32_t* full,
                     cudaStream_t st) {
  int full_blocks = 0;
  if (full != nullptr) {
    full_blocks = (hist_size + kBlockBins - 1) / kBlockBins;
    full_blocks = (full_blocks + CS - 1) / CS * CS;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * CS + full_blocks, 1, 1);
  cfg.blockDim = dim3(kBinThreads, 1, 1);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CS;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = CS > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, clahe_lut_kernel<CS>, hist, tiles, hist_size, clip, scale, lut,
      full);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---- CLAHE's blend ---------------------------------------------------------

// T: u8 (256 bins) or u16 (65536); vec: w % 4 == 0 (a thread's four
// pixels share a row) and the image and output aligned for four pixels
template <typename T>
__global__ void __launch_bounds__(kPixThreads)
clahe_blend_kernel(const T* __restrict__ img, int h, int w, int th, int tw,
                   int tiles_y, int tiles_x, int hist_size,
                   const uint16_t* __restrict__ lut, T* __restrict__ out,
                   bool vec) {
  const long long n = (long long)h * w;
  const long long i0 =
      ((long long)blockIdx.x * kPixThreads + threadIdx.x) * kBlendPix;
  if (i0 >= n) return;
  const size_t row_luts = (size_t)tiles_x * hist_size;
  if (vec) {
    const int y = (int)(i0 / w);
    const int x0 = (int)(i0 - (long long)y * w);
    T v[kBlendPix], o[kBlendPix];
    load_vec(img + i0, v);
    const Axis ay = axis_at(y, th, tiles_y);
    const uint16_t* r1 = lut + ay.t1 * row_luts;
    const uint16_t* r2 = lut + ay.t2 * row_luts;
#pragma unroll
    for (int k = 0; k < kBlendPix; ++k) {
      const Axis ax = axis_at(x0 + k, tw, tiles_x);
      const size_t a = (size_t)ax.t1 * hist_size + v[k];
      const size_t b = (size_t)ax.t2 * hist_size + v[k];
      o[k] = (T)blend_level(__ldg(r1 + a), __ldg(r1 + b), __ldg(r2 + a),
                            __ldg(r2 + b), ax, ay, hist_size);
    }
    store_vec(out + i0, o);
    return;
  }
  for (int k = 0; k < kBlendPix && i0 + k < n; ++k) {
    const long long i = i0 + k;
    const int y = (int)(i / w);
    const int x = (int)(i - (long long)y * w);
    const Axis ay = axis_at(y, th, tiles_y);
    const Axis ax = axis_at(x, tw, tiles_x);
    const uint16_t* r1 = lut + ay.t1 * row_luts;
    const uint16_t* r2 = lut + ay.t2 * row_luts;
    const size_t a = (size_t)ax.t1 * hist_size + img[i];
    const size_t b = (size_t)ax.t2 * hist_size + img[i];
    out[i] = (T)blend_level(__ldg(r1 + a), __ldg(r1 + b), __ldg(r2 + a),
                            __ldg(r2 + b), ax, ay, hist_size);
  }
}

template <typename T>
int launch_blend(const void* img, int h, int w, int tiles_y, int tiles_x,
                 int hist_size, const uint16_t* lut, void* out,
                 cudaStream_t st) {
  const int ph = h + (tiles_y - h % tiles_y) % tiles_y;
  const int pw = w + (tiles_x - w % tiles_x) % tiles_x;
  const long long n = (long long)h * w;
  const bool vec = w % kBlendPix == 0 && aligned(img, kBlendPix * sizeof(T)) &&
                   aligned(out, kBlendPix * sizeof(T));
  const long long threads = (n + kBlendPix - 1) / kBlendPix;
  const unsigned blocks = (unsigned)((threads + kPixThreads - 1) / kPixThreads);
  clahe_blend_kernel<T><<<blocks, kPixThreads, 0, st>>>(
      static_cast<const T*>(img), h, w, ph / tiles_y, pw / tiles_x, tiles_y,
      tiles_x, hist_size, lut, static_cast<T*>(out), vec);
  return (int)cudaGetLastError();
}

// ---- the stretches ---------------------------------------------------------

struct Taps {
  int32_t k0, k1;  // the order statistics' ranks + 1
  float low_w, high_w;
};

// One cluster of kMaxCluster blocks a 65536-bin histogram: the CLAHE
// image's (cluster 0), then, with ``full``, the disk's (cluster 1).  Each
// thread holds 8 bins in registers; a block scan and the lower blocks'
// totals (read from the cluster) give each thread its run's cumulative
// count, and the thread whose run crosses k finds the bin among its 8; the
// highest non-empty bin is a maximum over the cluster.  Rank 0 gathers the
// finds and writes the limits: params[0..1] from cluster 0, params[2..5]
// from cluster 1.
__global__ void __launch_bounds__(kBinThreads)
stretch_params_kernel(const int32_t* __restrict__ hist, Taps cc,
                      const int32_t* __restrict__ full, Taps fb,
                      float* __restrict__ params) {
  __shared__ int s_warp[32];
  __shared__ int s_part[2];   // this block's total and highest non-empty bin
  __shared__ int s_found[2];  // the bins of k0 and k1, where this block has
  cg::cluster_group cluster = cg::this_cluster();
  const bool second = blockIdx.x >= kMaxCluster;
  const int32_t* h = second ? full : hist;
  const Taps t = second ? fb : cc;
  const int rank = (int)cluster.block_rank();
  const int b0 = rank * kBlockBins + threadIdx.x * kThreadBins;
  if (threadIdx.x == 0) {
    s_part[1] = -1;
    s_found[0] = s_found[1] = -1;
  }
  __syncthreads();
  int32_t v[kThreadBins];
  load_vec(h + b0, v);
  int s = 0, last = -1;
#pragma unroll
  for (int k = 0; k < kThreadBins; ++k) {
    s += v[k];
    if (v[k] != 0) last = b0 + k;
  }
  if (last >= 0) atomicMax(&s_part[1], last);
  int total;
  int before = block_scan<kBinThreads>(s, s_warp, &total) - s;
  if (threadIdx.x == 0) s_part[0] = total;
  cluster.sync();
  int top = -1;
  for (int r = 0; r < kMaxCluster; ++r) {
    const int* part = cluster.map_shared_rank(s_part, r);
    if (r < rank) before += part[0];
    top = part[1] > top ? part[1] : top;
  }
  const int ks[2] = {t.k0, t.k1};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (before < ks[j] && ks[j] <= before + s) {
      int c = before;
#pragma unroll
      for (int k = 0; k < kThreadBins; ++k) {
        c += v[k];
        if (c >= ks[j]) {
          s_found[j] = b0 + k;
          break;
        }
      }
    }
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    // a rank past every count (none here: k <= the image's pixels) would
    // be the twin's searchsorted result, the bin count
    int found[2] = {kMaxCluster * kBlockBins, kMaxCluster * kBlockBins};
    for (int r = 0; r < kMaxCluster; ++r) {
      const int* f = cluster.map_shared_rank(s_found, r);
      for (int j = 0; j < 2; ++j) found[j] = f[j] >= 0 ? f[j] : found[j];
    }
    const float pct = lerp_taps(found[0], found[1], t.low_w, t.high_w);
    if (!second) {
      const Limits l = cc_limits(pct, top);
      params[0] = l.lo;
      params[1] = l.hi;
    } else {
      const float bright = bright_of(pct);
      const Limits lh = hc_limits(bright);
      const Limits lp = protus_limits(bright);
      params[2] = lh.lo;
      params[3] = lh.hi;
      params[4] = lp.lo;
      params[5] = lp.hi;
    }
  }
  cluster.sync();  // no block leaves while rank 0 reads it
}

// vec: every pointer aligned for eight pixels
__global__ void __launch_bounds__(kPixThreads)
stretch_kernel(const uint16_t* __restrict__ cl1,
               const uint16_t* __restrict__ img, long long n,
               const float* __restrict__ params, uint16_t* __restrict__ cc,
               uint16_t* __restrict__ hc, uint16_t* __restrict__ pr,
               bool vec) {
  const long long i0 =
      ((long long)blockIdx.x * kPixThreads + threadIdx.x) * kGainPix;
  if (i0 >= n) return;
  const bool full = vec && i0 + kGainPix <= n;
  uint16_t v[kGainPix], o[kGainPix];
  const Limits lc{params[0], params[1]};
  if (full) {
    load_vec(cl1 + i0, v);
#pragma unroll
    for (int k = 0; k < kGainPix; ++k) o[k] = stretch_px(value_f32(v[k]), lc);
    store_vec(cc + i0, o);
  } else {
    for (int k = 0; k < kGainPix && i0 + k < n; ++k) {
      cc[i0 + k] = stretch_px(value_f32(cl1[i0 + k]), lc);
    }
  }
  if (hc == nullptr && pr == nullptr) return;
  const Limits lh{params[2], params[3]}, lp{params[4], params[5]};
  if (full) {
    load_vec(img + i0, v);
    if (hc != nullptr) {
#pragma unroll
      for (int k = 0; k < kGainPix; ++k) o[k] = stretch_px(value_f32(v[k]), lh);
      store_vec(hc + i0, o);
    }
    if (pr != nullptr) {
#pragma unroll
      for (int k = 0; k < kGainPix; ++k) o[k] = stretch_px(value_f32(v[k]), lp);
      store_vec(pr + i0, o);
    }
    return;
  }
  for (int k = 0; k < kGainPix && i0 + k < n; ++k) {
    const float f = value_f32(img[i0 + k]);
    if (hc != nullptr) hc[i0 + k] = stretch_px(f, lh);
    if (pr != nullptr) pr[i0 + k] = stretch_px(f, lp);
  }
}

}  // namespace

// img: (h, w) C-contiguous u16 (elem_bytes 2) or float32 (4); gain: (h,)
// float32; out: (h, w) u16.
extern "C" int solex_row_gain(const void* img, int elem_bytes, int h, int w,
                              const float* gain, uint16_t* out,
                              void* stream) {
  if (h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    return launch_row_gain<uint16_t>(img, h, w, gain, out, st);
  }
  if (elem_bytes == 4) return launch_row_gain<float>(img, h, w, gain, out, st);
  return (int)cudaErrorInvalidValue;
}

// hist: (tiles, hist_size) int32, kernel B5's tile histograms; clip: the
// clip in counts (<= 0: none); scale: the float32 LUT scale; lut: (tiles,
// hist_size) u16 out; full: (hist_size,) int32, the tiles' sum, or null.
extern "C" int solex_clahe_lut(const int32_t* hist, int tiles, int hist_size,
                               int clip, float scale, uint16_t* lut,
                               int32_t* full, void* stream) {
  if (tiles < 1 || tiles > 65535 || hist_size < 1 ||
      hist_size > kMaxCluster * kBlockBins) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hist_size <= kBlockBins) {
    return launch_clahe_lut<1>(hist, tiles, hist_size, clip, scale, lut, full,
                               st);
  }
  return launch_clahe_lut<kMaxCluster>(hist, tiles, hist_size, clip, scale,
                                       lut, full, st);
}

// img: (h, w) C-contiguous u8 with 256 bins (elem_bytes 1) or u16 with
// 65536 (2); lut: solex_clahe_lut's; out: (h, w), the image's type.
extern "C" int solex_clahe_blend(const void* img, int elem_bytes, int h,
                                 int w, int tiles_y, int tiles_x,
                                 int hist_size, const uint16_t* lut,
                                 void* out, void* stream) {
  if (h < 1 || w < 1 || tiles_y < 1 || tiles_x < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1 && hist_size == 256) {
    return launch_blend<uint8_t>(img, h, w, tiles_y, tiles_x, hist_size, lut,
                                 out, st);
  }
  if (elem_bytes == 2 && hist_size == 65536) {
    return launch_blend<uint16_t>(img, h, w, tiles_y, tiles_x, hist_size, lut,
                                  out, st);
  }
  return (int)cudaErrorInvalidValue;
}

// hist: (65536,) int32, the CLAHE image's value histogram, and its
// percentile's ranks + 1 (k0, k1) and weights; full: the disk's value
// histogram with the 99.9999th percentile's, or null; params: 2 floats out
// (6 with full).
extern "C" int solex_stretch_params(const int32_t* hist, int k0, int k1,
                                    float low_w, float high_w,
                                    const int32_t* full, int f0, int f1,
                                    float f_low_w, float f_high_w,
                                    float* params, void* stream) {
  if (!aligned(hist, 16) || (full != nullptr && !aligned(full, 16))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kMaxCluster * (full != nullptr ? 2 : 1), 1, 1);
  cfg.blockDim = dim3(kBinThreads, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kMaxCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, stretch_params_kernel, hist, Taps{k0, k1, low_w, high_w}, full,
      Taps{f0, f1, f_low_w, f_high_w}, params);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// cl1, img: n u16 (img may be null when hc and pr are); params:
// solex_stretch_params'; cc: n u16 out; hc, pr: n u16 out or null.
extern "C" int solex_stretch(const uint16_t* cl1, const uint16_t* img,
                             long long n, const float* params, uint16_t* cc,
                             uint16_t* hc, uint16_t* pr, void* stream) {
  if (n < 1 || ((hc != nullptr || pr != nullptr) && img == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = aligned(cl1, 16) && aligned(cc, 16) &&
                   (img == nullptr || aligned(img, 16)) &&
                   (hc == nullptr || aligned(hc, 16)) &&
                   (pr == nullptr || aligned(pr, 16));
  const long long threads = (n + kGainPix - 1) / kGainPix;
  const unsigned blocks = (unsigned)((threads + kPixThreads - 1) / kPixThreads);
  stretch_kernel<<<blocks, kPixThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(cl1, img, n, params,
                                                        cc, hc, pr, vec);
  return (int)cudaGetLastError();
}
