// The launch plans of csrc/plans.cuh as C entry points of the host library
// (io/native.py builds this file with ser_io.cpp), for ops/fused_cuda.py and
// the tests: the plan the kernel library computes on the card, without a
// card.  A negative return is an argument the kernel library refuses.

#include "plans.cuh"

using namespace solex_plans;

// Pass A's plan for F frames of npix elements of elem_bytes (1 or 2) at
// ptr on a card that holds `slots` blocks at the split ring's shared
// memory, into out[10]: owned plan (1) or split (0), bulk path (1) or
// element (0), K, D, granules of a run, runs that take one more, shared
// bytes a block, blocks across a frame (grid x), grid y, frames a block.
extern "C" int solex_sum_max_plan_host(uintptr_t ptr, int elem_bytes, int F,
                                       long long npix, long long slots,
                                       long long* out) {
  if ((elem_bytes != 1 && elem_bytes != 2) || F < 1 || npix < 1 || slots < 1)
    return -1;
  sum_max::Plan p;
  sum_max::split_ring(ptr, elem_bytes, npix, &p);
  sum_max::make_plan(F, npix, elem_bytes, slots, &p);
  const long long v[10] = {p.owned, p.bulk, p.K, p.D, p.base, p.rem,
                           (long long)p.smem, p.blocks,
                           (F + p.fper - 1) / p.fper, p.fper};
  std::copy(v, v + 10, out);
  return 0;
}

// Kernel B1's plan for S shifts over (F, ih, iw) frames at ptr, into
// out[7]: bulk path (1) or element (0), yb, xw, K, D, fb, shared bytes a
// block; 1, or 0 where even the smallest plan does not fit.
extern "C" int solex_shg_fused_plan_host(uintptr_t ptr, int S, int ih, int iw,
                                         int* out) {
  if (S < 1 || ih < 1 || iw < 2) return -1;
  fused::Plan p;
  if (!fused::make_plan(ptr, S, ih, iw, &p)) return 0;
  const int v[7] = {p.bulk, p.yb, p.xw, p.K, p.D, p.fb, (int)p.smem};
  std::copy(v, v + 7, out);
  return 1;
}

// Kernel B6's plan for S shifts over (F, ih, iw) frames at ptr, into
// out[6]: bulk path (1) or element (0), yb, D, fb, bytes between two frames
// of a stage, shared bytes a block; 1, or 0 where even the smallest plan
// does not fit.
extern "C" int solex_shg_fused_mxu_plan_host(uintptr_t ptr, int S, int ih,
                                             int iw, int* out) {
  if (S < 1 || ih < 1 || iw < 2 || iw > fused_mxu::kCap) return -1;
  fused_mxu::Plan p;
  if (!fused_mxu::make_plan(ptr, S, ih, iw, &p)) return 0;
  const int v[6] = {p.bulk, p.yb, p.D, p.fb,
                    (int)fused_mxu::frame_stride(p.yb * iw), (int)p.smem};
  std::copy(v, v + 6, out);
  return 1;
}

extern "C" int solex_frames_per_block(long long tiles, long long slots,
                                      int F) {
  if (tiles < 1 || slots < 1 || F < 1) return -1;
  return frames_per_block(tiles, slots, F);
}

extern "C" long long solex_mxu_frame_stride(int n) {
  return (long long)fused_mxu::frame_stride(n);
}

// Into out[10]: threads of a block, the shared bytes a block may opt into,
// the ring's barrier bytes and most stages, the frame-split granule, pass
// A's longest run and shortest owned run (bytes) and an owned plan's most
// frames a stage, B1's longest run (elements), B6's widest row; returns 10.
extern "C" int solex_plan_limits(long long* out) {
  const long long v[10] = {kThreads, (long long)kMaxSmem,
                           (long long)kBarBytes, kMaxD, kSplitFrames,
                           (long long)sum_max::kMaxRunBytes,
                           (long long)sum_max::kMinOwnedRun,
                           sum_max::kOwnedMaxK, fused::kMaxRun,
                           fused_mxu::kCap};
  std::copy(v, v + 10, out);
  return 10;
}
