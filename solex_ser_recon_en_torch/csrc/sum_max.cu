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
// - A frame is a flat run of pixels, cut into 16-byte granules.  A block
//   owns a run of granules of every frame of its frame range; a ring of D
//   stages of K frames is filled by TMA bulk copies (a 16-byte aligned slab,
//   frames a multiple of 16 bytes) or by 16-byte cp.async granules
//   (anything else), chosen from the pointer and the shape alone.
// - Each thread keeps the int32 sums and packed maxima of its chunks in
//   registers and merges them into the outputs at the end.
// - Two launch plans, chosen from the pointer, the element size, the frame
//   count, the pixels of a frame and the card's block slots (SMs x blocks
//   an SM holds at the ring's shared memory) alone (csrc/plans.cuh):
//   * owned: the frame's granules split evenly over every slot (runs that
//     differ by one granule at most, one full wave; more waves of whole
//     slots only where a run would pass 16 KB), each block reading every
//     frame of the launch for its run, in stages of up to 16 frames and
//     64 KB (a block waits and synchronises once a stage, so few long
//     stages stream faster than many short ones) within the split ring's
//     shared memory.  No two blocks touch one pixel, so the merge is a
//     plain load, add (max) and store, no atomics.  Two launches into one
//     accumulator pair are ordered by the stream the caller launches them
//     on: the caller keeps them on one stream.
//   * split: where a frame is too small to give every slot a run of
//     kMinOwnedRun bytes, runs of up to 16 KB over a frame split, the split
//     chosen so that the last wave is as full as it can be; blocks that
//     share pixels merge with atomicAdd / atomicMax.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ring.cuh"

namespace {

using namespace solex_ring;
using namespace solex_plans::sum_max;

// Add an owned run's sums to sb[0 .. nacc) and raise mb[0 .. nacc) to its
// maxima with plain loads and stores: no other block of the launch touches
// these pixels.  16-byte vectors where both outputs are aligned.
template <int EB, int P>
__device__ __forceinline__ void merge_owned(const SumMax<EB, P>& a,
                                            int32_t* sb, int32_t* mb,
                                            int nacc, int nch, int tid) {
  constexpr int kPer = SumMax<EB, P>::kPer;
  constexpr int kIn = kPer / 4;                  // elements of a word
  constexpr uint32_t kMask = EB == 2 ? 0xffffu : 0xffu;
  const bool vec = ((reinterpret_cast<uintptr_t>(sb) |
                     reinterpret_cast<uintptr_t>(mb)) & 15) == 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int c = tid + p * kThreads;
    if (c >= nch) continue;
    const int e0 = kPer * c;
    uint32_t m[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      m[i] = (a.m[p][i / kIn] >> (8 * EB * (i % kIn))) & kMask;
    if (vec && e0 + kPer <= nacc) {
      uint4* vs = reinterpret_cast<uint4*>(sb + e0);
      int4* vm = reinterpret_cast<int4*>(mb + e0);
      uint4 s4[kPer / 4];
      int4 m4[kPer / 4];
#pragma unroll
      for (int q = 0; q < kPer / 4; ++q) {
        s4[q] = vs[q];
        m4[q] = vm[q];
      }
#pragma unroll
      for (int q = 0; q < kPer / 4; ++q) {
        s4[q].x += a.s[p][4 * q];
        s4[q].y += a.s[p][4 * q + 1];
        s4[q].z += a.s[p][4 * q + 2];
        s4[q].w += a.s[p][4 * q + 3];
        m4[q].x = max(m4[q].x, (int32_t)m[4 * q]);
        m4[q].y = max(m4[q].y, (int32_t)m[4 * q + 1]);
        m4[q].z = max(m4[q].z, (int32_t)m[4 * q + 2]);
        m4[q].w = max(m4[q].w, (int32_t)m[4 * q + 3]);
        vs[q] = s4[q];
        vm[q] = m4[q];
      }
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = e0 + i;
        if (e < nacc) {
          sb[e] = (int32_t)((uint32_t)sb[e] + a.s[p][i]);
          mb[e] = max(mb[e], (int32_t)m[i]);
        }
      }
    }
  }
}

template <bool kBulk, int EB>
__global__ void __launch_bounds__(kThreads, 2)
sum_max_kernel(const unsigned char* __restrict__ frames,
               int32_t* __restrict__ sum, int32_t* __restrict__ mx, int F,
               long long npix, long long base, long long rem, int K, int D,
               int fper, int owned) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kGpx = 16 / EB;                  // pixels of a granule
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  const long long p0 = (b * base + min(b, rem)) * kGpx;
  const int fs = blockIdx.y * fper;
  const int fe = min(F, fs + fper);
  const int n = (int)min((base + (b < rem)) * kGpx, npix - p0);  // pixels
  const int nch = (n * EB + 15) / 16;
  const size_t fst = stage_frame_bytes((size_t)(base + (rem > 0)) * 16);

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
#pragma unroll 2
    for (int m = 0; m < mc; ++m) {
      const int head =
          kBulk ? 0 : (int)((run0_addr + (size_t)(f0 + m) * frame_b) & 15);
      acc.template add<kBulk>(slot + m * fst, head, n, nch, tid);
    }
  }

  if (owned)
    merge_owned(acc, sum + p0, mx + p0, n, nch, tid);
  else
    acc.merge(sum + p0, mx + p0, n, nch, tid);
}

struct Launch {
  Plan plan;
  int blocks_per_sm, sms;
  dim3 grid;
};

template <bool kBulk, int EB>
cudaError_t configure(int F, long long npix, Launch* L) {
  Plan& p = L->plan;
  const cudaError_t err = block_slots(sum_max_kernel<kBulk, EB>, p.smem,
                                      &L->blocks_per_sm, &L->sms);
  if (err != cudaSuccess) return err;
  make_plan(F, npix, EB, (long long)L->blocks_per_sm * L->sms, &p);
  if (p.blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  L->grid = dim3((unsigned)p.blocks, (unsigned)((F + p.fper - 1) / p.fper));
  return cudaSuccess;
}

cudaError_t configure(const void* frames, int eb, int F, long long npix,
                      Launch* L) {
  if ((eb != 1 && eb != 2) || F < 1 || npix < 1) return cudaErrorInvalidValue;
  split_ring(reinterpret_cast<uintptr_t>(frames), eb, npix, &L->plan);
  if (eb == 2)
    return L->plan.bulk ? configure<true, 2>(F, npix, L)
                        : configure<false, 2>(F, npix, L);
  return L->plan.bulk ? configure<true, 1>(F, npix, L)
                      : configure<false, 1>(F, npix, L);
}

template <bool kBulk, int EB>
void launch(const unsigned char* frames, int32_t* sum, int32_t* mx, int F,
            long long npix, const Launch& L, cudaStream_t st) {
  const Plan& p = L.plan;
  sum_max_kernel<kBulk, EB><<<L.grid, kThreads, p.smem, st>>>(
      frames, sum, mx, F, npix, p.base, p.rem, p.K, p.D, p.fper, p.owned);
}

}  // namespace

// frames: (F, npix) unsigned elements of elem_bytes (1 or 2), C-contiguous;
// sum, mx: (npix,) i32, accumulated into (the caller zeroes them before the
// first chunk, and launches every chunk into one pair on one stream).  The
// caller keeps the frames of all chunks within 32767, so that the int32
// sum stays exact.  `owned`, where not null, receives 1 for the owned plan
// and 0 for the split plan.
extern "C" int solex_sum_max(const void* frames, int elem_bytes, int32_t* sum,
                             int32_t* mx, int F, long long npix,
                             void* stream, int* owned) {
  Launch L;
  cudaError_t err = configure(frames, elem_bytes, F, npix, &L);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* src = static_cast<const unsigned char*>(frames);
  if (elem_bytes == 2) {
    if (L.plan.bulk) launch<true, 2>(src, sum, mx, F, npix, L, st);
    else launch<false, 2>(src, sum, mx, F, npix, L, st);
  } else {
    if (L.plan.bulk) launch<true, 1>(src, sum, mx, F, npix, L, st);
    else launch<false, 1>(src, sum, mx, F, npix, L, st);
  }
  if (owned) *owned = L.plan.owned;
  return (int)cudaGetLastError();
}

// The launch plan solex_sum_max would use for these arguments, into
// out[12]: owned plan (1) or split (0), bulk path (1) or element (0), K, D,
// granules of a run, runs that take one more, shared bytes a block, blocks
// an SM holds, SMs, grid x, grid y, frames a block.
extern "C" int solex_sum_max_plan(const void* frames, int elem_bytes, int F,
                                  long long npix, long long* out) {
  Launch L;
  const cudaError_t err = configure(frames, elem_bytes, F, npix, &L);
  if (err != cudaSuccess) return (int)err;
  const Plan& p = L.plan;
  const long long v[12] = {p.owned, p.bulk, p.K, p.D, p.base, p.rem,
                           (long long)p.smem, L.blocks_per_sm, L.sms,
                           L.grid.x, L.grid.y, p.fper};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}
