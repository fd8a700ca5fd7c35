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

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace solex_ring {

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

}  // namespace solex_ring
