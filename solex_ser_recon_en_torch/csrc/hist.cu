// Kernel B5: exact per-tile value histograms for CLAHE and the percentile
// stretches.
//
// Replaces the Pallas kernel solex_ser_recon_en_tpu/ops/clahe.py:_hist_kernel
// (_make_hist_kernel, driven by _tile_histograms_mxu).
//
//   out[t, b] = #{ i : tiles[t, i] == b },   0 <= b < hist_size
//
// Values outside [0, hist_size) are skipped (the callers pad with -1).
//
// What bounds it on an H100: atomics.  A CLAHE tile of a solar disk holds
// millions of pixels piled on a few hundred values (the sky background and
// the limb-darkened disk), so global atomics would serialise on those
// bins.  Each block instead counts a slice of one tile into shared memory
// and adds its non-zero bins to the output once.  65536 bins x 4 B is more
// than the 227 KB of shared memory a block can have, so the bin range is
// split into passes of 32768 bins (128 KB of dynamic shared memory, one
// block per SM); blockIdx.z selects the pass and each pass reads the slice
// again.  Integer atomics make the counts exact and independent of the
// order in which blocks run.  On the TPU the same counts came from a
// 256 x 256 one-hot outer product on the MXU, because it has no scatter.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPassBins = 32768;
constexpr int kThreads = 1024;

__global__ void tile_hist_kernel(const int32_t* __restrict__ tiles, int n,
                                 int hist_size, int chunk,
                                 int32_t* __restrict__ out) {
  extern __shared__ int32_t bins[];
  const int t = blockIdx.y;
  const int lo = blockIdx.z * kPassBins;
  const int nb = min(kPassBins, hist_size - lo);
  for (int i = threadIdx.x; i < nb; i += kThreads) bins[i] = 0;
  __syncthreads();
  const int32_t* v = tiles + (size_t)t * n;
  const int start = blockIdx.x * chunk;
  const int end = min(n, start + chunk);
  for (int i = start + threadIdx.x; i < end; i += kThreads) {
    const int b = v[i] - lo;
    if ((unsigned)b < (unsigned)nb) atomicAdd(&bins[b], 1);
  }
  __syncthreads();
  int32_t* o = out + (size_t)t * hist_size + lo;
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    const int32_t c = bins[i];
    if (c) atomicAdd(&o[i], c);
  }
}

}  // namespace

// tiles: (T, n) i32; out: (T, hist_size) i32, zeroed here on the stream.
extern "C" int solex_tile_hist(const int32_t* tiles, int T, int n,
                               int hist_size, int chunk, int32_t* out,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)T * hist_size * sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  const int pass_bins = hist_size < kPassBins ? hist_size : kPassBins;
  const size_t smem = (size_t)pass_bins * sizeof(int32_t);
  err = cudaFuncSetAttribute(tile_hist_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int passes = (hist_size + kPassBins - 1) / kPassBins;
  const dim3 grid((n + chunk - 1) / chunk, T, passes);
  tile_hist_kernel<<<grid, kThreads, smem, st>>>(tiles, n, hist_size, chunk,
                                                 out);
  return (int)cudaGetLastError();
}
