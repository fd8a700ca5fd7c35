// The launch plans of pass A (csrc/sum_max.cu), kernel B1 (csrc/fused.cu)
// and kernel B6 (csrc/fused_mxu.cu), each in a namespace of its own, what
// they share and every constant they are made from.  Plain C++17 with no
// CUDA header: the kernel library (nvcc) and the host library (g++,
// csrc/plans.cpp) both build it, so a plan is written once; integer
// arithmetic only, so both give the same answers.  What only the card
// knows (the blocks it holds at once) comes in as `slots`.  SOLEX_HD marks
// what device code calls too.

#pragma once

#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#ifdef __CUDACC__
#define SOLEX_HD __host__ __device__
#else
#define SOLEX_HD
#endif

namespace solex_plans {

constexpr int kThreads = 256;                    // threads of a block
constexpr int kMaxD = 8;                         // stages in a ring, at most
constexpr size_t kBarBytes = 8 * kMaxD;          // the stages' mbarriers
constexpr int kSplitFrames = 32;                 // frame-split granule
constexpr size_t kMaxSmem = 232448;              // opt-in limit of a block

SOLEX_HD inline size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Frames a block takes (a multiple of kSplitFrames) when `tiles` blocks
// cover one frame and the card holds `slots` blocks at once: the split
// whose last wave is fullest, then the one with fewer blocks.
inline int frames_per_block(long long tiles, long long slots, int F) {
  const int nfb = (F + kSplitFrames - 1) / kSplitFrames;
  const int top =
      (int)std::min((long long)nfb, 4 * ((slots + tiles - 1) / tiles));
  long long best_blocks = 0, best_cap = 1;
  int best = kSplitFrames * nfb;
  for (int sp = 1; sp <= top; ++sp) {
    const int fper = kSplitFrames * ((nfb + sp - 1) / sp);
    const long long blocks = tiles * ((F + fper - 1) / fper);
    const long long cap = (blocks + slots - 1) / slots * slots;
    if (sp == 1 || blocks * best_cap > best_blocks * cap) {
      best_blocks = blocks;
      best_cap = cap;
      best = fper;
    }
  }
  return best;
}

// Pass A (csrc/sum_max.cu).
namespace sum_max {

constexpr int kChunks = 4;                       // 16-byte chunks a thread owns
constexpr size_t kMaxRunBytes = 16 * kChunks * kThreads;
constexpr int kMaxK = 8;                         // frames per stage
constexpr int kOwnedMaxK = 16;                   // of an owned plan
constexpr size_t kStageTarget = 16 * 1024;
constexpr size_t kOwnedStageTarget = 64 * 1024;  // an owned plan's stages
constexpr size_t kRingTarget = 100 * 1024;
// the shortest run an owned plan gives a block: below it most of a block's
// threads hold no chunk of the run, and at a chunk's frame count the split
// plan's 16 KB runs stream faster (measured on an H100: PERF.md section 6)
constexpr size_t kMinOwnedRun = 1024;

struct Plan {
  int bulk, owned, K, D, fper;                   // fper: frames a block
  long long blocks;                              // blocks across a frame
  long long base, rem;   // granules of a run; the first rem runs take one more
  size_t smem;
};

// bytes of one frame's run in the ring (+16: the element path's offset)
SOLEX_HD inline size_t stage_frame_bytes(size_t run_bytes) {
  return align16(run_bytes) + 16;
}

// K frames a stage (towards `stage` bytes, at most max_k) and D stages for
// runs of `granules`, the ring within `cap` bytes; returns the block's
// shared memory
inline size_t size_ring(long long granules, size_t stage, int max_k,
                        size_t cap, Plan* p) {
  const size_t fst = stage_frame_bytes((size_t)granules * 16);
  p->K = (int)std::min((size_t)max_k, std::max((size_t)1, stage / fst));
  while (p->K & (p->K - 1)) --p->K;              // a power of two
  while (p->K > 1 && 2 * p->K * fst > cap) p->K /= 2;  // two stages fit
  p->D = (int)std::min((size_t)kMaxD,
                       std::max((size_t)2, cap / (p->K * fst)));
  return kBarBytes + (size_t)p->D * p->K * fst;
}

// The split plan's ring, whose shared memory sets the card's block slots
// for both plans: runs of up to 16 KB.
inline void split_ring(uintptr_t ptr, int eb, long long npix, Plan* p) {
  const long long G = (npix * eb + 15) / 16;     // granules of a frame
  p->bulk = ptr % 16 == 0 && npix * eb % 16 == 0;
  p->owned = 0;
  p->base = std::min(G, (long long)(kMaxRunBytes / 16));
  p->rem = 0;
  p->blocks = (G + p->base - 1) / p->base;
  p->smem = size_ring(p->base, kStageTarget, kMaxK, kRingTarget, p);
}

// The launch plan for F frames at `slots` blocks the card holds at once
// (at the split ring's shared memory, p->smem on entry).
inline void make_plan(int F, long long npix, int eb, long long slots,
                      Plan* p) {
  const long long G = (npix * eb + 15) / 16;
  const long long max_g = kMaxRunBytes / 16, min_g = kMinOwnedRun / 16;
  if (G >= slots * min_g) {
    p->owned = 1;
    p->blocks = slots * ((G + slots * max_g - 1) / (slots * max_g));
    p->base = G / p->blocks;
    p->rem = G % p->blocks;
    // the split ring's shared memory, so the slots stay those counted
    size_ring(p->base + (p->rem > 0), kOwnedStageTarget, kOwnedMaxK,
              p->smem - kBarBytes, p);
    p->fper = F;
  } else {
    p->fper = frames_per_block(p->blocks, slots, F);
  }
}

}  // namespace sum_max

// Kernel B1 (csrc/fused.cu).
namespace fused {

constexpr int kChunks = 4;                       // 16-byte chunks a thread owns
constexpr int kMaxRun = 8 * kChunks * kThreads;  // elements a block holds a frame
constexpr int kMaxRows = 64;
constexpr int kMaxK = 8;                         // frames per stage
constexpr size_t kStageTarget = 16 * 1024;
constexpr size_t kRingTarget = 72 * 1024;

struct Plan {
  int bulk, yb, xw, K, D, fb;
  size_t smem;
};

// bytes of one frame's run in the ring (+16: the element path's offset)
SOLEX_HD inline size_t frame_bytes(int n) {
  return align16(2 * (size_t)n) + 16;
}

// longest run a block holds: whole rows, or a column chunk and its tap column
SOLEX_HD inline int max_run(int yb, int xw, int iw) {
  return xw < iw ? xw + 1 : yb * iw;
}

inline size_t smem_bytes(int S, int yb, int K, int D, int fb, int nmax) {
  return kBarBytes + (size_t)D * K * frame_bytes(nmax) +
         align16(2 * (size_t)S * yb * fb) + 4 * (size_t)S * yb + 4 * (size_t)yb;
}

// The launch geometry; false when even yb = K = 1, D = 2 and 8-frame disk
// stores do not fit.
inline bool make_plan(uintptr_t ptr, int S, int ih, int iw, Plan* p) {
  const bool aligned = ptr % 16 == 0 && ((long long)ih * iw) % 8 == 0;
  p->xw = iw > kMaxRun ? kMaxRun - 1 : iw;
  p->yb = 1;
  if (p->xw == iw) {
    // rows: a bulk-aligned run first, then the larger share of the threads'
    // chunk slots used (n / P), then more rows
    long long bn = 0, bP = 1;
    bool bb = false;
    const int top = std::min(std::min(ih, kMaxRows), kMaxRun / iw);
    for (int yb = 1; yb <= top; ++yb) {
      const long long n = (long long)yb * iw;
      const long long P = (n + 8 * kThreads - 1) / (8 * kThreads);
      const bool b = aligned && n % 8 == 0;
      if (yb == 1 || (b && !bb) || (b == bb && n * bP >= bn * P)) {
        p->yb = yb;
        bn = n;
        bP = P;
        bb = b;
      }
    }
  }
  const bool want_bulk = p->xw == iw && aligned && ((long long)p->yb * iw) % 8 == 0;
  size_t fst = frame_bytes(max_run(p->yb, p->xw, iw));
  p->K = (int)std::min((size_t)kMaxK, std::max((size_t)1, kStageTarget / fst));
  while (p->K & (p->K - 1)) --p->K;              // a power of two
  p->D = (int)std::min((size_t)kMaxD,
                       std::max((size_t)2, kRingTarget / (p->K * fst)));
  p->fb = 32;
  while ((p->smem = smem_bytes(S, p->yb, p->K, p->D, p->fb,
                               max_run(p->yb, p->xw, iw))) > kMaxSmem) {
    if (p->D > 2) {
      --p->D;
    } else if (p->K > 1) {
      p->K /= 2;
    } else if (p->yb > 1) {
      do --p->yb;
      while (p->yb > 1 && want_bulk && ((long long)p->yb * iw) % 8 != 0);
    } else if (p->fb > 8) {
      p->fb /= 2;
    } else {
      return false;
    }
  }
  p->bulk = p->xw == iw && aligned && ((long long)p->yb * iw) % 8 == 0;
  return true;
}

}  // namespace fused

// Kernel B6 (csrc/fused_mxu.cu).
namespace fused_mxu {

constexpr int kM = 8;                     // frames per mma tile and per stage
constexpr int kN = 8;                     // shifts per mma tile
constexpr int kCap = 3072;                // elements (rows x iw) per block
constexpr int kMaxRows = 8;
constexpr size_t kStageTarget = 20 * 1024;
constexpr size_t kRingTarget = 60 * 1024;

struct Plan {
  int bulk, yb, D, fb;
  size_t smem;
};

// bytes between two frames of a stage: room for the run and the element
// path's offset (2 n + 16), rounded up to 16 more than a multiple of 128
SOLEX_HD inline size_t frame_stride(int n) {
  return ((2 * (size_t)n + 16 + 127) & ~size_t(127)) + 16;
}

inline size_t smem_bytes(int S, int iw, int yb, int D, int fb) {
  const size_t nsg = (S + kN - 1) / kN;
  return kBarBytes + (size_t)D * kM * frame_stride(yb * iw) +
         align16(2 * (size_t)S * yb * fb) + 16 * (size_t)yb +
         8 * (size_t)yb * nsg + 4 * (size_t)yb * nsg * kN;
}

// The launch geometry; false when even yb = 1, D = 2 and 8-frame disk
// stores do not fit.
inline bool make_plan(uintptr_t ptr, int S, int ih, int iw, Plan* p) {
  const bool aligned = ptr % 16 == 0 && ((long long)ih * iw) % 8 == 0;
  // rows: a bulk-aligned run first, then the longest run whose stage stays
  // within kStageTarget (the shortest run, if none does)
  const int top = std::min(std::min(ih, kMaxRows), kCap / iw);
  long long bkey = 0;
  bool bb = false;
  p->yb = 1;
  for (int yb = 1; yb <= top; ++yb) {
    const long long n = (long long)yb * iw;
    const bool b = aligned && n % 8 == 0;
    const long long key = kM * frame_stride((int)n) <= kStageTarget ? n : -n;
    if (yb == 1 || (b && !bb) || (b == bb && key > bkey)) {
      p->yb = yb;
      bkey = key;
      bb = b;
    }
  }
  const bool want_bulk = bb;
  p->D = (int)std::min(
      (size_t)kMaxD,
      std::max((size_t)2, kRingTarget / (kM * frame_stride(p->yb * iw))));
  p->fb = 32;
  while ((p->smem = smem_bytes(S, iw, p->yb, p->D, p->fb)) > kMaxSmem) {
    if (p->D > 2) {
      --p->D;
    } else if (p->yb > 1) {
      do --p->yb;
      while (p->yb > 1 && want_bulk && ((long long)p->yb * iw) % 8 != 0);
    } else if (p->fb > 8) {
      p->fb /= 2;
    } else {
      return false;
    }
  }
  p->bulk = aligned && ((long long)p->yb * iw) % 8 == 0;
  return true;
}

}  // namespace fused_mxu

}  // namespace solex_plans
