// Kernel B1 (B2 folded in): the fused single-pass device step — int32 frame
// sum, frame max and the multi-shift disks from ONE read of the normalised
// frame slab.
//
// Replaces the Pallas kernels of solex_ser_recon_en_tpu/ops/fused_pallas.py:
// _kernel_win (the 128-lane windowed body, B1) and _kernel (the full-width
// body, B2), both driven by _shg_fused.  The two are bit-identical by
// construction (the window only drops exact +0.0 mask terms), so one kernel
// serves both.
//
//   sum[y, x]      = sum_f frames[f, y, x]                  (int32)
//   max[y, x]      = max_f frames[f, y, x]
//   disks[s, y, f] = u16(clip(w[y] * frames[f, y, l] +
//                             (1 - w[y]) * frames[f, y, l + 1], 0, 65535))
//   l = clamp(ind_l[s, y], 0, iw - 2)
//
// The lerp is csrc/recon.cu's arithmetic, rounded the same way (no FMA,
// each product and the sum rounded separately; the file is also built with
// --fmad=false), so on the same frames B1's disks equal B3's bit for bit.
//
// What bounds it on an H100: bytes.  Every frame byte has to be read once:
// 2.458 GB for the 2000 x 2048 x 300 bench slab, plus 16.4 MB of disks at
// S = 2 and two 2.5 MB int32 accumulators, 2.479 GB in all, 0.74 ms at
// 3.35 TB/s.  The integer work (an add and a max per element) and the
// lerps are far below the card's rates.  So the design keeps enough bytes
// in flight on every SM, and keeps the threads' work between barriers
// even:
//
// - A block owns `yb` whole rows and a range of frames, so a frame's part
//   is one contiguous run of yb * iw u16.  yb is chosen on the host so that
//   the run's 16-byte chunks fall evenly on the 256 threads (at most 4
//   each) and, where it can, so that the run is a multiple of 16 bytes.
// - A ring of D stages in shared memory, each K frames of the block's run,
//   is filled by asynchronous copies while the block consumes the oldest
//   stage.  Bulk path: one thread issues one TMA bulk copy per frame
//   (cp.async.bulk, 1-D) completing on the stage's mbarrier.  It needs a
//   16-byte aligned slab, yb * iw and ih * iw multiples of 8.  Element path
//   (any other pointer or shape, and the column split below): the threads
//   copy the 16-byte granules that hold the run, aligned down, with
//   cp.async (the granule at the slab's end clipped, zero fill), and the
//   run sits at a per-frame offset of 0-7 elements in the stage.  The path
//   follows from the pointer and the shape alone (make_plan); it is never
//   a fallback.
// - Sum and max: each thread owns fixed 16-byte chunks of the run across
//   all frames, reads them from the stage (uint4 on the bulk path), keeps
//   int32 sums and packed u16x2 maxima in registers, and merges them at the
//   end with integer atomicAdd / atomicMax into the zeroed outputs, exact in
//   any block order.
// - Taps: after a stage's barrier, S x rows x K (shift, row, frame) items
//   take their two taps from the stage and lerp into a (S, yb, fb) staging
//   tile, written out every fb frames, 16 bytes at a time where the disks'
//   rows allow it (F a multiple of 8).
// - Grid: (column chunks, row tiles, frame splits).  The frame split is
//   chosen from the blocks an SM holds (cudaOccupancyMaxActiveBlocks...)
//   so that the last wave is as full as it can be.
// - Rows wider than 8192 columns (more than a thread's 4 chunks) are split
//   over blockIdx.x: a block then owns one row of a column chunk, loads one
//   column more than it accumulates, and takes the taps whose left column
//   it holds.  That split takes the element path.
//
// At the bench shape (iw = 300, S = 2): yb = 20 (6000 elements, 750 chunks
// on 256 threads: 3 each, 98% of the slots used), K = 1, D = 6 stages of
// 12,016 bytes, 75 KB of shared memory a block and 5 stages (60 KB) in
// flight per block; 103 row tiles.  An H100 holds 2 such blocks an SM
// (blocks_per_sm of solex_shg_fused_plan: 96 registers a thread under
// __launch_bounds__(kThreads, 2) leave room for 2, though shared memory
// would take 3), so the frame split is sized for 264 blocks at once:
// 103 x 5 blocks of 416 frames.
//
// Not carried over from the TPU kernel: the 128-lane window and its
// host-side selector, the iota-compare mask scratch with its float32 copy
// of the tile (a gather needs neither), the padding to the Mosaic lane rule,
// and the sequential frame grid that revisited the accumulators.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "ring.cuh"

namespace {

using namespace solex_ring;

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
__host__ __device__ inline size_t frame_bytes(int n) {
  return align16(2 * (size_t)n) + 16;
}

// longest run a block holds: whole rows, or a column chunk and its tap column
__host__ __device__ inline int max_run(int yb, int xw, int iw) {
  return xw < iw ? xw + 1 : yb * iw;
}

size_t smem_bytes(int S, int yb, int K, int D, int fb, int nmax) {
  return kBarBytes + (size_t)D * K * frame_bytes(nmax) +
         align16(2 * (size_t)S * yb * fb) + 4 * (size_t)S * yb + 4 * (size_t)yb;
}

// The launch geometry (ops/fused_cuda.py:fused_plan mirrors it); false when
// even yb = K = 1, D = 2 and 8-frame disk stores do not fit.
bool make_plan(uintptr_t ptr, int S, int ih, int iw, Plan* p) {
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

template <bool kBulk>
__global__ void __launch_bounds__(kThreads, 2)
fused_kernel(const uint16_t* __restrict__ frames,
             const int32_t* __restrict__ ind_l,
             const float* __restrict__ left_w, int32_t* __restrict__ sum,
             int32_t* __restrict__ mx, uint16_t* __restrict__ disks, int S,
             int F, int ih, int iw, int yb, int xw, int K, int D, int fb,
             int fper, int disk_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * xw;
  const int y0 = blockIdx.y * yb;
  const int fs = blockIdx.z * fper;            // a multiple of kSplitFrames
  const int fe = min(F, fs + fper);
  const int rows = min(yb, ih - y0);
  const int cols = min(xw, iw - x0);           // columns accumulated here
  const int lcols = min(xw + 1, iw - x0);      // columns loaded (+ right tap)
  const int n = rows * lcols;                  // run length of a frame
  const int nacc = xw == iw ? n : cols;        // run elements accumulated
  const int nch = (nacc + 7) / 8;
  const size_t fst = frame_bytes(max_run(yb, xw, iw));

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + kBarBytes;
  uint16_t* tile =
      reinterpret_cast<uint16_t*>(ring + (size_t)D * K * fst);  // [S][yb][fb]
  int32_t* loc = reinterpret_cast<int32_t*>(
      reinterpret_cast<unsigned char*>(tile) + align16(2 * (size_t)S * yb * fb));
  float* wsm = reinterpret_cast<float*>(loc + (size_t)S * yb);

  // tap column of every (s, y) relative to x0, or -1 when the left tap
  // belongs to another column chunk
  for (int j = tid; j < S * yb; j += kThreads) {
    const int s = j / yb;
    const int yl = j - s * yb;
    int c = -1;
    if (yl < rows) {
      const int l = min(max(ind_l[(size_t)s * ih + y0 + yl], 0), iw - 2);
      if (l >= x0 && l < x0 + cols) c = l - x0;
    }
    loc[j] = c;
  }
  for (int j = tid; j < yb; j += kThreads)
    wsm[j] = j < rows ? left_w[y0 + j] : 0.0f;
  if (kBulk && tid == 0) {
    for (int i = 0; i < D; ++i) mbar_init(bars + i, 1);
    fence_mbar_init();
  }
  __syncthreads();

  const size_t fpix = (size_t)ih * iw;
  const uint16_t* run0 = frames + (size_t)y0 * iw + x0;   // frame 0's run
  const uintptr_t run0_addr = reinterpret_cast<uintptr_t>(run0);
  const uintptr_t slab_end =
      reinterpret_cast<uintptr_t>(frames + (size_t)F * fpix);
  const int nst = (fe - fs + K - 1) / K;       // stages of this block

  // element offset of frame f's run in its granules (0 on the bulk path)
  auto head = [&](int f) -> int {
    return kBulk ? 0 : (int)(((run0_addr + 2 * (size_t)f * fpix) & 15) >> 1);
  };

  // fill stage j (frames fs + j*K ...) into slot j % D
  auto issue = [&](int j) {
    const int f0 = fs + j * K;
    fill_stage<kBulk>(ring + (size_t)(j % D) * K * fst, fst, bars + j % D,
                      run0_addr, 2 * fpix, f0, j < nst ? min(K, fe - f0) : 0,
                      (uint32_t)(n * 2), slab_end, tid);
  };

  SumMax<2, kChunks> acc;
  acc.clear();

  for (int j = 0; j < D - 1; ++j) issue(j);

  for (int k = 0; k < nst; ++k) {
    wait_stage<kBulk>(bars, k, D);
    __syncthreads();              // stage k landed; stage k - 1 was read
    issue(k + D - 1);             // into stage k - 1's slot

    const unsigned char* slot = ring + (size_t)(k % D) * K * fst;
    const int f0 = fs + k * K;
    const int mc = min(K, fe - f0);
    for (int m = 0; m < mc; ++m)
      acc.add<kBulk>(slot + m * fst, 2 * head(f0 + m), nacc, nch, tid);

    // taps of every (shift, row, frame) of the stage
    for (int q = tid; q < S * rows * mc; q += kThreads) {
      const int m = q % mc;
      const int r = q / mc;
      const int s = r / rows;
      const int yl = r - s * rows;
      const int c = loc[s * yb + yl];
      if (c >= 0) {
        const int f = f0 + m;
        const uint16_t* row = reinterpret_cast<const uint16_t*>(slot + m * fst) +
                              head(f) + yl * lcols;
        const float x0f = (float)row[c];
        const float x1f = (float)row[c + 1];
        const float w = wsm[yl];
        float v = __fadd_rn(__fmul_rn(w, x0f),
                            __fmul_rn(__fsub_rn(1.0f, w), x1f));
        v = fminf(fmaxf(v, 0.0f), 65535.0f);
        tile[(s * yb + yl) * fb + (f - fs) % fb] = (uint16_t)(int)v;
      }
    }

    // write the staged disks every fb frames (K divides fb)
    const int fl = f0 + mc - 1;
    if ((fl - fs + 1) % fb == 0 || fl == fe - 1) {  // the same for all threads
      __syncthreads();
      const int fb0 = fl - (fl - fs) % fb;
      const int ng = fb / 8;
      for (int q = tid; q < S * rows * ng; q += kThreads) {
        const int g = q % ng;
        const int r = q / ng;
        const int s = r / rows;
        const int yl = r - s * rows;
        const int f = fb0 + 8 * g;
        const int cnt = min(8, fe - f);
        if (cnt <= 0 || loc[s * yb + yl] < 0) continue;
        const uint16_t* src = tile + (s * yb + yl) * fb + 8 * g;
        uint16_t* dst = disks + ((size_t)s * ih + y0 + yl) * F + f;
        if (cnt == 8 && disk_vec) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int i = 0; i < cnt; ++i) dst[i] = src[i];
        }
      }
    }
  }

  acc.merge(sum + (size_t)y0 * iw + x0, mx + (size_t)y0 * iw + x0, nacc, nch,
            tid);
}

struct Launch {
  Plan plan;
  int blocks_per_sm, fper;
  dim3 grid;
};

// the plan, the kernel's shared-memory attribute, its occupancy and a grid
// whose last wave is as full as a frame split allows
template <bool kBulk>
cudaError_t configure(int F, int ih, int iw, Launch* L) {
  const Plan& p = L->plan;
  int sms = 0;
  const cudaError_t err =
      block_slots(fused_kernel<kBulk>, p.smem, &L->blocks_per_sm, &sms);
  if (err != cudaSuccess) return err;

  const long long nx = (iw + p.xw - 1) / p.xw;
  const long long ny = (ih + p.yb - 1) / p.yb;
  L->fper = frames_per_block(nx * ny, (long long)L->blocks_per_sm * sms, F);
  L->grid = dim3((unsigned)nx, (unsigned)ny,
                 (unsigned)((F + L->fper - 1) / L->fper));
  return cudaSuccess;
}

cudaError_t configure(uintptr_t ptr, int S, int F, int ih, int iw,
                      Launch* L) {
  if (S < 1 || F < 1 || ih < 1 || iw < 2 ||
      !make_plan(ptr, S, ih, iw, &L->plan))
    return cudaErrorInvalidValue;
  return L->plan.bulk ? configure<true>(F, ih, iw, L)
                      : configure<false>(F, ih, iw, L);
}

}  // namespace

// frames: (F, ih, iw) u16, C-contiguous, normalised orientation;
// ind_l: (S, ih) i32; left_w: (ih,) f32.  Outputs: sum, mx (ih, iw) i32,
// zeroed here on the stream; disks (S, ih, F) u16.  F <= 32767 keeps the
// int32 sum exact (65535 * 32767 < 2^31).
extern "C" int solex_shg_fused(const uint16_t* frames, const int32_t* ind_l,
                               const float* left_w, int32_t* sum, int32_t* mx,
                               uint16_t* disks, int S, int F, int ih, int iw,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Launch L;
  cudaError_t err =
      configure(reinterpret_cast<uintptr_t>(frames), S, F, ih, iw, &L);
  if (err != cudaSuccess) return (int)err;
  const size_t acc = (size_t)ih * iw * sizeof(int32_t);
  err = cudaMemsetAsync(sum, 0, acc, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(mx, 0, acc, st);
  if (err != cudaSuccess) return (int)err;

  const Plan& p = L.plan;
  const int disk_vec = F % 8 == 0 && reinterpret_cast<uintptr_t>(disks) % 16 == 0;
  if (p.bulk)
    fused_kernel<true><<<L.grid, kThreads, p.smem, st>>>(
        frames, ind_l, left_w, sum, mx, disks, S, F, ih, iw, p.yb, p.xw, p.K,
        p.D, p.fb, L.fper, disk_vec);
  else
    fused_kernel<false><<<L.grid, kThreads, p.smem, st>>>(
        frames, ind_l, left_w, sum, mx, disks, S, F, ih, iw, p.yb, p.xw, p.K,
        p.D, p.fb, L.fper, disk_vec);
  return (int)cudaGetLastError();
}

// The launch geometry solex_shg_fused would use for these arguments, into
// out[12]: bulk path (1) or element path (0), yb, xw, K, D, fb, shared
// bytes a block, blocks an SM holds, grid x, y, z, frames per block.
extern "C" int solex_shg_fused_plan(const uint16_t* frames, int S, int F,
                                    int ih, int iw, int* out) {
  Launch L;
  const cudaError_t err =
      configure(reinterpret_cast<uintptr_t>(frames), S, F, ih, iw, &L);
  if (err != cudaSuccess) return (int)err;
  const Plan& p = L.plan;
  const int v[12] = {p.bulk, p.yb, p.xw, p.K, p.D, p.fb, (int)p.smem,
                     L.blocks_per_sm, (int)L.grid.x, (int)L.grid.y,
                     (int)L.grid.z, L.fper};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}
