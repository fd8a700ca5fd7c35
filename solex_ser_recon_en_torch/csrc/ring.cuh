// Device helpers for a ring of stages in shared memory filled by
// asynchronous copies from device memory (sm_90).
//
// Two ways to fill a stage:
// - bulk: one thread asks the copy engine (TMA, 1-D, no tensor map) for a
//   contiguous run of bytes; the copy reports its bytes to an mbarrier of
//   the stage, on which the block waits with the stage's phase parity.
//   Source, destination and size must be multiples of 16 bytes.
// - element: every thread issues 16-byte cp.async copies of aligned
//   granules (the last one clipped with zero fill), commits them as one
//   group per stage, and waits until at most n groups are pending.
//
// A stage is released for refill by a __syncthreads() after it was read;
// fence_proxy_async() then orders the refill (async proxy) after the reads.
//
// On top of the copies, what the kernels that walk a frame slab share
// (csrc/fused.cu, csrc/fused_mxu.cu, csrc/sum_max.cu): a block owns one
// contiguous run of every frame of its frame range; fill_stage / wait_stage
// move the runs of a few frames into a ring slot and wait for them; SumMax
// keeps a thread's int32 sums and packed maxima of its fixed 16-byte chunks
// of the run and merges them into the int32 outputs with atomics.  The
// ring's limits, the frame split and the kernels' launch plans are in
// csrc/plans.cuh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "plans.cuh"

namespace solex_ring {

using namespace solex_plans;

constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one thread: arm an mbarrier for `count` arrivals per phase
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// after mbar_init, before any other thread uses the barriers (then a
// __syncthreads())
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// arrive once and expect `bytes` from bulk copies in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// bulk copy of `bytes` (a multiple of 16) from device to shared memory,
// completing on `bar`
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// 16-byte copy of an aligned granule; only `src_bytes` (0..16) are read,
// the rest of the 16 destination bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// wait until at most `pending` (0..7) of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// Fill a ring slot with the runs of frames f0 .. f0 + mc - 1.  `run0` is
// the address of frame 0's run, `frame_bytes` the bytes between two frames
// in device memory, `run_bytes` the length of a run, `fst` the bytes between
// two frames in the slot, `slab_end` the address past the last frame.
// Bulk: thread 0 arms `bar` and starts one bulk copy a frame (run0,
// frame_bytes and run_bytes multiples of 16).  Element: the threads copy
// the 16-byte granules that hold each run, aligned down, so that a run
// starts (address & 15) bytes into its frame's part of the slot; every
// thread commits one group per call, even an empty one.
template <bool kBulk>
__device__ __forceinline__ void fill_stage(unsigned char* slot, size_t fst,
                                           uint64_t* bar, uintptr_t run0,
                                           size_t frame_bytes, int f0, int mc,
                                           uint32_t run_bytes,
                                           uintptr_t slab_end, int tid) {
  if (kBulk) {
    if (tid == 0 && mc > 0) {
      fence_proxy_async();
      mbar_expect_tx(bar, (uint32_t)mc * run_bytes);
      for (int m = 0; m < mc; ++m)
        bulk_g2s(slot + m * fst,
                 reinterpret_cast<const void*>(
                     run0 + (size_t)(f0 + m) * frame_bytes),
                 run_bytes, bar);
    }
  } else {
    const int ngm = (int)((run_bytes + 30) / 16);  // granules of a run, at most
    for (int q = tid; q < mc * ngm; q += kThreads) {
      const int m = q / ngm;
      const int g = q - m * ngm;
      const uintptr_t a = run0 + (size_t)(f0 + m) * frame_bytes;
      if (g < (int)(((a & 15) + run_bytes + 15) / 16)) {
        const uintptr_t src = (a & ~uintptr_t(15)) + 16 * (uintptr_t)g;
        const uintptr_t left = slab_end - src;
        cp_async16(slot + m * fst + 16 * g,
                   reinterpret_cast<const void*>(src),
                   (uint32_t)(left < 16 ? left : 16));
      }
    }
    cp_async_commit();
  }
}

// Wait for stage k of a ring of D stages whose fills were started in order,
// D - 1 ahead (stage k sits in slot k % D, on that slot's barrier in its
// (k / D)-th phase).
template <bool kBulk>
__device__ __forceinline__ void wait_stage(uint64_t* bars, int k, int D) {
  if (kBulk)
    mbar_wait(bars + k % D, (uint32_t)((k / D) & 1));
  else
    cp_async_wait_pending(D - 2);
}

// A thread's sums and maxima of its 16-byte chunks tid + p * kThreads
// (p < P) of a run of EB-byte unsigned elements, over the frames added.
template <int EB, int P>
struct SumMax {
  static constexpr int kPer = 16 / EB;             // elements of a chunk
  uint32_t s[P][kPer];                             // sums
  uint32_t m[P][4];                                // packed u16x2 / u8x4 maxima

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) s[p][i] = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) m[p][i] = 0;
    }
  }

  // One frame's run of `nacc` elements in `nch` chunks.  Bulk: the run
  // starts at `fr` (16-byte aligned).  Element: it starts `head` bytes in.
  template <bool kBulk>
  __device__ __forceinline__ void add(const unsigned char* fr, int head,
                                      int nacc, int nch, int tid) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int c = tid + p * kThreads;
      if (c < nch) {
        uint32_t w[4];
        if (kBulk) {
          const uint4 q = reinterpret_cast<const uint4*>(fr)[c];
          w[0] = q.x;
          w[1] = q.y;
          w[2] = q.z;
          w[3] = q.w;
        } else if (EB == 2) {
          const uint16_t* v = reinterpret_cast<const uint16_t*>(fr + head);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = 8 * c + 2 * i;
            const uint32_t lo = e < nacc ? v[e] : 0u;
            const uint32_t hi = e + 1 < nacc ? v[e + 1] : 0u;
            w[i] = lo | hi << 16;
          }
        } else {
          const unsigned char* v = fr + head;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            w[i] = 0;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int e = 16 * c + 4 * i + b;
              w[i] |= (e < nacc ? (uint32_t)v[e] : 0u) << (8 * b);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (EB == 2) {
            s[p][2 * i] += w[i] & 0xffffu;
            s[p][2 * i + 1] += w[i] >> 16;
            m[p][i] = __vmaxu2(m[p][i], w[i]);
          } else {
#pragma unroll
            for (int b = 0; b < 4; ++b)
              s[p][(4 * i + b) % kPer] += (w[i] >> (8 * b)) & 0xffu;
            m[p][i] = __vmaxu4(m[p][i], w[i]);
          }
        }
      }
    }
  }

  // Add the sums to sb[0 .. nacc) and raise mb[0 .. nacc) to the maxima:
  // integer atomics, exact in any block order.
  __device__ __forceinline__ void merge(int32_t* sb, int32_t* mb, int nacc,
                                        int nch, int tid) const {
    constexpr int kIn = kPer / 4;                  // elements of a word
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int c = tid + p * kThreads;
      if (c < nch) {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int e = kPer * c + i;
          if (e < nacc) {
            atomicAdd(&sb[e], (int32_t)s[p][i]);
            atomicMax(&mb[e], (int32_t)((m[p][i / kIn] >>
                                         (8 * EB * (i % kIn))) &
                                        (EB == 2 ? 0xffffu : 0xffu)));
          }
        }
      }
    }
  }
};

// Blocks of `kernel` an SM holds at `smem` dynamic bytes (raising the
// kernel's limit past the default where needed), and the card's SM count.
template <typename Kernel>
cudaError_t block_slots(Kernel kernel, size_t smem, int* blocks_per_sm,
                        int* sms) {
  cudaError_t err = cudaSuccess;
  if (smem > kDefaultSmem)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                        kThreads, smem);
  if (err == cudaSuccess && *blocks_per_sm < 1)
    err = cudaErrorInvalidConfiguration;
  return err;
}

}  // namespace solex_ring
