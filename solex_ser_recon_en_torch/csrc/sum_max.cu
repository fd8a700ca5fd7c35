// Pass A on the card: int32 frame sum and frame max of a chunk of frames,
// accumulated into outputs the caller holds.
//
//   sum[p] += sum_f frames[f, p]        (int32)
//   max[p]  = max(max[p], max_f frames[f, p])
//
// over the pixels p of a frame, for u8 or u16 frames in any layout: a sum
// and a max over frames do not depend on the orientation, so a raw chunk as
// stored in the file and the normalised slab go through the same kernel.
//
// It replaces no TPU kernel: the JAX package leaves pass A to an XLA
// reduction (solex_ser_recon_en_tpu/ops/fused.py:33-34).  Here it replaces
// three PyTorch passes (an int32 copy of the chunk, a sum and an amax) with
// one read of the frames: it is kernel B1 (csrc/fused.cu) without shifts,
// the ring and the sum/max consumer of csrc/ring.cuh and nothing else.
//
// What bounds it on an H100: bytes.  The frames are read once (2.458 GB for
// the 2000 x 2048 x 300 u16 bench slab) and the two int32 accumulators
// merged once (4.9 MB): 0.735 ms at 3.35 TB/s.
//
// - A frame is a flat run of pixels.  A block owns up to 16 KB of every
//   frame (4 16-byte chunks for each of its 256 threads) over a range of
//   frames; a ring of D stages of K frames is filled by TMA bulk copies (a
//   16-byte aligned slab, frames and runs multiples of 16 bytes) or by
//   16-byte cp.async granules (anything else), chosen from the pointer and
//   the shape alone.
// - Each thread keeps the int32 sums and packed maxima of its chunks in
//   registers and merges them at the end with atomicAdd / atomicMax, which
//   is also what lets a caller accumulate chunk after chunk.
// - Grid: (runs of a frame, frame splits), the split chosen from the blocks
//   an SM holds so that the last wave is as full as it can be.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "ring.cuh"

namespace {

using namespace solex_ring;

constexpr int kChunks = 4;                       // 16-byte chunks a thread owns
constexpr size_t kMaxRunBytes = 16 * kChunks * kThreads;
constexpr int kMaxK = 8;                         // frames per stage
constexpr size_t kStageTarget = 16 * 1024;
constexpr size_t kRingTarget = 100 * 1024;

struct Plan {
  int bulk, K, D;
  long long run;                                 // pixels of a block's run
  size_t smem;
};

// bytes of one frame's run in the ring (+16: the element path's offset)
__host__ __device__ inline size_t stage_frame_bytes(size_t run_bytes) {
  return align16(run_bytes) + 16;
}

void make_plan(uintptr_t ptr, int eb, long long npix, Plan* p) {
  const size_t frame_b = (size_t)npix * eb;
  const size_t run_b = std::min(frame_b, kMaxRunBytes);
  p->run = (long long)(run_b / eb);
  p->bulk = ptr % 16 == 0 && frame_b % 16 == 0 && run_b % 16 == 0;
  const size_t fst = stage_frame_bytes(run_b);
  p->K = (int)std::min((size_t)kMaxK, std::max((size_t)1, kStageTarget / fst));
  while (p->K & (p->K - 1)) --p->K;              // a power of two
  p->D = (int)std::min((size_t)kMaxD,
                       std::max((size_t)2, kRingTarget / (p->K * fst)));
  p->smem = kBarBytes + (size_t)p->D * p->K * fst;
}

template <bool kBulk, int EB>
__global__ void __launch_bounds__(kThreads, 2)
sum_max_kernel(const unsigned char* __restrict__ frames,
               int32_t* __restrict__ sum, int32_t* __restrict__ mx, int F,
               long long npix, int run, int K, int D, int fper) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * run;
  const int fs = blockIdx.y * fper;
  const int fe = min(F, fs + fper);
  const int n = (int)min((long long)run, npix - p0);   // pixels of the run
  const int nch = (n * EB + 15) / 16;
  const size_t fst = stage_frame_bytes((size_t)run * EB);

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + kBarBytes;
  if (kBulk && tid == 0) {
    for (int i = 0; i < D; ++i) mbar_init(bars + i, 1);
    fence_mbar_init();
  }
  __syncthreads();

  const size_t frame_b = (size_t)npix * EB;
  const uintptr_t run0_addr =
      reinterpret_cast<uintptr_t>(frames) + (size_t)p0 * EB;
  const uintptr_t slab_end =
      reinterpret_cast<uintptr_t>(frames) + (size_t)F * frame_b;
  const int nst = (fe - fs + K - 1) / K;         // stages of this block

  auto fill = [&](int j) {
    const int f0 = fs + j * K;
    fill_stage<kBulk>(ring + (size_t)(j % D) * K * fst, fst, bars + j % D,
                      run0_addr, frame_b, f0, j < nst ? min(K, fe - f0) : 0,
                      (uint32_t)(n * EB), slab_end, tid);
  };

  SumMax<EB, kChunks> acc;
  acc.clear();

  for (int j = 0; j < D - 1; ++j) fill(j);

  for (int k = 0; k < nst; ++k) {
    wait_stage<kBulk>(bars, k, D);
    __syncthreads();              // stage k landed; stage k - 1 was read
    fill(k + D - 1);              // into stage k - 1's slot

    const unsigned char* slot = ring + (size_t)(k % D) * K * fst;
    const int f0 = fs + k * K;
    const int mc = min(K, fe - f0);
    for (int m = 0; m < mc; ++m) {
      const int head =
          kBulk ? 0 : (int)((run0_addr + (size_t)(f0 + m) * frame_b) & 15);
      acc.template add<kBulk>(slot + m * fst, head, n, nch, tid);
    }
  }

  acc.merge(sum + p0, mx + p0, n, nch, tid);
}

template <bool kBulk, int EB>
cudaError_t launch(const unsigned char* frames, int32_t* sum, int32_t* mx,
                   int F, long long npix, const Plan& p, cudaStream_t st) {
  int blocks_per_sm = 0, sms = 0;
  const cudaError_t err = block_slots(sum_max_kernel<kBulk, EB>, p.smem,
                                      &blocks_per_sm, &sms);
  if (err != cudaSuccess) return err;
  const long long tiles = (npix + p.run - 1) / p.run;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int fper = frames_per_block(tiles, (long long)blocks_per_sm * sms, F);
  const dim3 grid((unsigned)tiles, (unsigned)((F + fper - 1) / fper));
  sum_max_kernel<kBulk, EB><<<grid, kThreads, p.smem, st>>>(
      frames, sum, mx, F, npix, (int)p.run, p.K, p.D, fper);
  return cudaGetLastError();
}

}  // namespace

// frames: (F, npix) unsigned elements of elem_bytes (1 or 2), C-contiguous;
// sum, mx: (npix,) i32, accumulated into (the caller zeroes them before the
// first chunk).  The caller keeps the frames of all chunks within 32767, so
// that the int32 sum stays exact.
extern "C" int solex_sum_max(const void* frames, int elem_bytes, int32_t* sum,
                             int32_t* mx, int F, long long npix,
                             void* stream) {
  if ((elem_bytes != 1 && elem_bytes != 2) || F < 1 || npix < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* src = static_cast<const unsigned char*>(frames);
  Plan p;
  make_plan(reinterpret_cast<uintptr_t>(frames), elem_bytes, npix, &p);
  cudaError_t err;
  if (elem_bytes == 2)
    err = p.bulk ? launch<true, 2>(src, sum, mx, F, npix, p, st)
                 : launch<false, 2>(src, sum, mx, F, npix, p, st);
  else
    err = p.bulk ? launch<true, 1>(src, sum, mx, F, npix, p, st)
                 : launch<false, 1>(src, sum, mx, F, npix, p, st);
  return (int)err;
}
