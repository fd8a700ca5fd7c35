// Kernel B5: exact per-tile value histograms for CLAHE and the percentile
// stretches, read from the u8/u16 image itself.
//
// Replaces the Pallas kernel solex_ser_recon_en_tpu/ops/clahe.py:_hist_kernel
// (_make_hist_kernel, driven by _tile_histograms_mxu).
//
//   out[t, b] = #{ pixels p of tile t : value(p) == b },  0 <= b < hist_size
//
// The tiles are those of cv2's CLAHE: the (h, w) image padded at the
// bottom and right with BORDER_REFLECT_101 to a multiple of the
// (tiles_y, tiles_x) grid (padded row r >= h reads row 2h-2-r, likewise for
// columns), cut into tiles_y x tiles_x tiles of th x tw pixels, tile t =
// ty * tiles_x + tx.  The kernel works each pixel's tile and reflected
// source out itself, so the caller makes no padded, permuted or widened
// copy.  A (T, n) int32 tile tensor is the case h = T, w = n, one 1-row
// tile per row; values outside [0, hist_size) are skipped.
//
// What bounds it on an H100: bytes in principle (2 B a u16 pixel read once
// and 4 B an output bin written once: ~19 MB, 0.006 ms, for the two calls
// of the bench image); in practice the fixed cost of blocks that each hold
// a whole histogram.  The design, as measurements on the card chose it
// (PERF.md):
// - One block holds all 65536 bins as 16-bit counters packed in pairs into
//   32768 words (128 KB of shared memory, one block an SM) and counts with
//   plain shared atomics.  A block takes at most 65535 values, so no
//   counter can overflow and the counts stay exact.  (A first version that
//   split int32 bins over a 2-block cluster, counted through distributed
//   shared memory and merged equal values in a warp with __match_any_sync
//   took 2.9 times as long on an H100: remote atomics and the match are
//   slow.)
// - Each warp walks items: one tile row, 32 x kUnits consecutive 8-byte
//   units (4 u16 pixels), loaded coalesced, all before any count; pixels of
//   neighbouring tiles are masked, and no pixel needs a division.  An image
//   whose rows are not 8-byte aligned takes the same walk in 1-pixel units.
//   The warp that takes a row's first item counts its reflected padding
//   columns.
// - The blocks of a tile form clusters of 4 for wide histograms; after
//   counting, each block sums a quarter of the words over its cluster
//   through distributed shared memory (plain loads) and adds the non-zero
//   sums to the output with integer atomics (exact, and independent of the
//   order blocks run in): up to 4 times fewer global atomics.
// - Grid: one wave of the card's active clusters spread over the tiles, at
//   most one block per 32 items, and at least the blocks that keep each
//   under 65536 values.  Above 65536 bins (int32 tiles only) the bin range
//   is cut into passes along blockIdx.z, each reading the values again.
// - The shared-memory size is set and the cluster occupancy checked once
//   per process and instantiation; a cluster that cannot be placed is
//   refused.
// On the TPU the same counts came from a 256 x 256 one-hot outer product on
// the MXU, because it has no scatter.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kPassBins = 65536;   // bins a pass: 32768 words, 128 KB
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 4;          // units a lane loads per item
constexpr int kMaxValues = 65535;  // values a block: no u16 counter overflows

struct Geometry {
  int h, w;     // image
  int th, tw;   // tile (of the padded image)
  int tiles_x;
  int hist_size;
  int cpr;      // items a tile row
  int words;    // shared words a pass, a multiple of 4 x the cluster size
};

// kVec: 8-byte units of 8 / sizeof(T) pixels; else 1-pixel units
template <typename T, bool kVec>
struct Unit {
  static constexpr int V = kVec ? 8 / (int)sizeof(T) : 1;
  using U = typename std::conditional<kVec, uint2, T>::type;
  __device__ __forceinline__ static int get(const U& x, int e) {
    T v[V];
    memcpy(v, &x, sizeof(U));
    return (int)v[e];
  }
};

__device__ __forceinline__ void count(uint32_t* words, int key) {
  atomicAdd(words + (key >> 1), 1u << ((key & 1) << 4));
}

template <typename T, int CS, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    hist_kernel(const T* __restrict__ img, Geometry g,
                int32_t* __restrict__ out) {
  using Un = Unit<T, kVec>;
  constexpr int V = Un::V;
  extern __shared__ uint4 smem[];
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = threadIdx.x; i < g.words / 4; i += kThreads) {
    smem[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const int lo = blockIdx.z * kPassBins;              // first bin of the pass
  const int span = min(kPassBins, g.hist_size - lo);  // bins of the pass
  const int t = blockIdx.y;
  const int ty = t / g.tiles_x, tx = t - ty * g.tiles_x;
  const int c_lo = tx * g.tw, c_hi = c_lo + g.tw, c_re = min(c_hi, g.w);
  const int u_lo = c_lo / V, u_hi = (c_re + V - 1) / V;  // a row's units
  const int items = g.th * g.cpr;
  const int per = (items + gridDim.x - 1) / gridDim.x;
  const int k0 = (int)min((long long)items, (long long)blockIdx.x * per);
  const int k1 = min(items, k0 + per);
  const int lane = threadIdx.x & 31;
  for (int k = k0 + (int)(threadIdx.x >> 5); k < k1; k += kWarps) {
    const int row = k / g.cpr;
    const int j = k - row * g.cpr;
    const int r = ty * g.th + row;
    const T* src = img + (size_t)(r < g.h ? r : 2 * g.h - 2 - r) * g.w;
    const typename Un::U* units = reinterpret_cast<const typename Un::U*>(src);
    const int u0 = u_lo + j * 32 * kUnits + lane;
    typename Un::U x[kUnits];
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {  // all loads first
      if (u0 + u * 32 < u_hi) x[u] = units[u0 + u * 32];
    }
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      if (u0 + u * 32 < u_hi) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int c = (u0 + u * 32) * V + e;
          const int key = Un::get(x[u], e) - lo;
          if (c >= c_lo && c < c_re && (unsigned)key < (unsigned)span) {
            count(words, key);
          }
        }
      }
    }
    if (j == 0) {  // the row's reflected padding columns
      for (int c = max(g.w, c_lo) + lane; c < c_hi; c += 32) {
        const int key = (int)src[2 * g.w - 2 - c] - lo;
        if ((unsigned)key < (unsigned)span) count(words, key);
      }
    }
  }
  if constexpr (CS > 1) {
    cluster.sync();  // every block of the cluster has counted
  } else {
    __syncthreads();
  }

  // this block sums its share of the words over the cluster and adds the
  // non-zero bins to the output
  const int rank = CS > 1 ? (int)cluster.block_rank() : 0;
  const int share = g.words / 4 / CS;  // in uint4 (8 bins)
  int32_t* o = out + (size_t)t * g.hist_size + lo;
  for (int i = rank * share + (int)threadIdx.x; i < (rank + 1) * share;
       i += kThreads) {
    int sum[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int q = 0; q < CS; ++q) {
      const uint4 v = CS > 1 ? cluster.map_shared_rank(smem, q)[i] : smem[i];
      const uint32_t a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sum[2 * e] += (int)(a[e] & 0xffff);
        sum[2 * e + 1] += (int)(a[e] >> 16);
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (sum[e] && 8 * i + e < span) atomicAdd(o + 8 * i + e, sum[e]);
    }
  }
  if constexpr (CS > 1) {
    cluster.sync();  // no block leaves while its peers read its counters
  }
}

int round_up(long long x, int m) { return (int)((x + m - 1) / m * m); }

template <typename T, int CS, bool kVec>
int launch(const void* img, Geometry g, int tiles, int32_t* out,
           cudaStream_t st) {
  constexpr int V = Unit<T, kVec>::V;
  constexpr int kSmem = kPassBins / 2 * (int)sizeof(uint32_t);
  auto kernel = hist_kernel<T, CS, kVec>;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CS;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // set-up once per process and instantiation: the shared-memory limit and
  // the card's active-cluster count
  static int max_clusters = -1;
  if (max_clusters < 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    cfg.gridDim = dim3(CS, 1, 1);
    cfg.dynamicSmemBytes = kSmem;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (n < 1) return (int)cudaErrorLaunchOutOfResources;  // cannot place
    max_clusters = n;
  }
  const int span = g.hist_size < kPassBins ? g.hist_size : kPassBins;
  g.words = round_up((span + 1) / 2, 4 * CS);
  const int passes = (g.hist_size + kPassBins - 1) / kPassBins;
  const int units = (g.tw + V - 1) / V + (V > 1);  // the most a tile row has
  g.cpr = (units + 32 * kUnits - 1) / (32 * kUnits);
  const long long items = (long long)g.th * g.cpr;
  const int pad = g.tiles_x * g.tw - g.w;  // padding columns a row
  const int item_values = 32 * kUnits * V + pad;
  if (item_values > kMaxValues) return (int)cudaErrorInvalidValue;
  const int per_block = kMaxValues / item_values;  // items
  // blocks a tile: one wave of clusters over the tiles, at most one block
  // per 32 items, at least those that keep each under 65536 values
  const long long wave = (long long)(max_clusters / (tiles * passes)) * CS;
  const long long most = round_up((items + 31) / 32, CS);
  const int fewest = round_up((items + per_block - 1) / per_block, CS);
  int cpt = (int)(wave < most ? wave : most);
  cpt = round_up(cpt > fewest ? cpt : fewest, CS);
  if (cpt < CS) cpt = CS;
  cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)tiles * g.hist_size * sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  cfg.gridDim = dim3(cpt, tiles, passes);
  cfg.dynamicSmemBytes = g.words * sizeof(uint32_t);
  cfg.stream = st;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(img), g, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Dispatch on element type, cluster size (4 for wide histograms, 1 for
// small ones) and unit width (8-byte units where the image's rows allow).
template <typename T>
int dispatch(const void* img, Geometry g, int tiles, int32_t* out,
             cudaStream_t st) {
  const bool vec = reinterpret_cast<uintptr_t>(img) % 8 == 0 &&
                   (size_t)g.w * sizeof(T) % 8 == 0;
  if (g.hist_size > 4096) {
    return vec ? launch<T, 4, true>(img, g, tiles, out, st)
               : launch<T, 4, false>(img, g, tiles, out, st);
  }
  return vec ? launch<T, 1, true>(img, g, tiles, out, st)
             : launch<T, 1, false>(img, g, tiles, out, st);
}

}  // namespace

// img: (h, w) C-contiguous u8 (elem_bytes 1), u16 (2) or int32 (4);
// out: (tiles_y * tiles_x, hist_size) i32, zeroed here on the stream.
extern "C" int solex_tile_hist(const void* img, int elem_bytes, int h, int w,
                               int tiles_y, int tiles_x, int hist_size,
                               int32_t* out, void* stream) {
  const int ph = h + (tiles_y - h % tiles_y) % tiles_y;
  const int pw = w + (tiles_x - w % tiles_x) % tiles_x;
  const Geometry g{h, w, ph / tiles_y, pw / tiles_x, tiles_x, hist_size, 0, 0};
  const int tiles = tiles_y * tiles_x;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1) return dispatch<uint8_t>(img, g, tiles, out, st);
  if (elem_bytes == 2) return dispatch<uint16_t>(img, g, tiles, out, st);
  return dispatch<int32_t>(img, g, tiles, out, st);
}
