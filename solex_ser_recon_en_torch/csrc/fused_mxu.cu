// Kernel B6: the fused single-pass device step with the multi-shift
// extraction on the FP64 tensor cores — int32 frame sum, frame max and the
// disks from ONE read of the normalised frame slab.
//
// Replaces the Pallas kernel solex_ser_recon_en_tpu/ops/fused_pallas.py:
// _kernel_mxu (driven by _shg_fused_mxu, the `mxu=True` switch of
// shg_fused_pallas).  Same contract as kernel B1 (csrc/fused.cu); the disks
// come from one contraction over the spectral axis, batched over rows y:
//
//   sum[y, x]      = sum_f frames[f, y, x]                  (int32)
//   max[y, x]      = max_f frames[f, y, x]
//   disks[s, y, f] = u16(trunc(clip(f32(sum_x frames[f, y, x] * comb[y, s, x]),
//                                   0, 65535)))
//   comb[y, s, x]  = w[y] at x = l, f32(1 - w[y]) at x = l + 1, else 0,
//   l = ind_l[s, y]  (not clipped: a tap outside [0, iw) is absent, as the
//                     TPU kernel's iota compare leaves it)
//
// Why FP64 (DMMA, mma.sync m8n8k4 .f64), not TF32: TF32 keeps 10 mantissa
// bits, which breaks the 1-LSB disk contract.  In FP64 a u16 value and an
// f32 weight are exact, each product (at most 40 significant bits) is
// exact, and every other term of the sum is an exact +0, so every order of
// summation gives round_f64(a*w + b*(1-w)).  That is rounded to f32, then
// clipped and truncated as the TPU kernel does; the plain version
// (ops/fused_cuda.py:shg_fused_mxu_plain) repeats it bit for bit.
//
// The mma tile: M = 8 frames, N = 8 shifts (S padded with zero columns of
// B), K = 4 spectral columns, one warp per (row y, group of 8 shifts).
// Fragments (PTX ISA, m8n8k4 .f64; CUTLASS arch/mma_sm80.h GemmShape<8,8,4>):
// lane l holds A[l / 4][l % 4], B[l % 4][l / 4] and D[l / 4][2 (l % 4) + i].
// Each lane builds its B element in registers from (ind_l, w): no comb
// scratch.  A is read from the stage in shared memory; K past iw reads as
// 0.0, and a u16 of any bits is a finite double (NaN * 0 would be NaN).
//
// K is windowed: a warp contracts only the 4-column chunks between the
// lowest and the highest in-range tap of its 8 shifts, where some lane's B
// element is not zero.  The chunks skipped hold only exact +0 products, so
// the result is bit-identical to the full-width contraction of the TPU
// kernel (4 chunks at S = 2 on the bench scan instead of 75).
//
// What bounds it on an H100: bytes.  Every frame byte is read once (2.458
// GB for the 2000 x 2048 x 300 bench slab: 0.73 ms at 3.35 TB/s); the disks
// (16.4 MB at S = 2) and the two (ih, iw) int32 accumulators (4.9 MB) are
// small, and even the full-width FP64 contraction (19.7 GFLOP) would take
// 0.29 ms at 67 TFLOP/s.  So the design is about how the bytes reach the
// SM; it is kernel B1's (csrc/fused.cu), on the helpers of csrc/ring.cuh:
//
// - A block owns `yb` whole rows (one contiguous run of yb * iw <= 3072
//   u16 a frame) and a range of frames.  A ring of D stages in shared
//   memory, each one M tile (8 frames of the run), is filled by
//   asynchronous copies while the block works on the oldest stage.  Bulk
//   path: one thread starts one TMA bulk copy per frame onto the stage's
//   mbarrier (a 16-byte aligned slab, yb * iw and ih * iw multiples of 8).
//   Element path (any other pointer or shape): 16-byte cp.async granules,
//   the run at a per-frame offset of 0-7 elements.  The path follows from
//   the pointer and the shape alone (csrc/plans.cuh), never as a fallback.
// - The stage is the A tile: a lane reads its A element (frame lane / 4)
//   straight from the ring slot.  Frames sit frame_stride bytes apart, 16
//   more than a multiple of 128, so the 8 frames of a fragment start 4
//   banks apart and, on the bulk path, its 8-byte pieces never share a
//   bank, wherever the row starts (on the element path the frames' offsets
//   differ, and two pieces can meet in a bank).  Frames of the last stage
//   past the block's range are not copied: whatever u16 the slot holds
//   converts to a finite double, and their D rows are not stored.
// - Sum and max as B1: each thread owns fixed 16-byte chunks of the run,
//   reads them as uint4 from the stage, keeps int32 sums and packed u16x2
//   maxima in registers and merges them at the end with atomicAdd /
//   atomicMax into the zeroed outputs (ring.cuh:SumMax).
// - What does not depend on the frame is computed once a block, into shared
//   memory: every (row, shift group)'s 8 tap columns and K window, and
//   every row's w and f32(1 - w) as doubles.
// - The D fragments go into an (S, yb, fb) staging tile, written out every
//   fb frames, 16 bytes at a time where the disks' rows allow it (F a
//   multiple of 8).
// - Grid: (row tiles, frame splits), the frame split chosen from the blocks
//   an SM holds so that the last wave is as full as it can be.
//
// At the bench shape (iw = 300): yb = 4 (1200 elements, 150 chunks), stages
// of 8 x 2448 = 19,584 bytes, D = 3 (2 stages in flight a block), 58 KB of
// shared memory and 3 blocks an SM; 512 row tiles x 3 frame splits.  The
// ring is kept that small on purpose: on the bench slab a third block an SM
// was worth more than a deeper ring at 2 blocks an SM, which was slower
// (PERF.md has the numbers).  The staging tile, tap columns and windows grow with S;
// a shift count whose smallest plan does not fit the block's shared memory
// (several thousand shifts) is refused.
//
// Not carried over from the TPU kernel: the (YB, S, iw) float32 comb
// scratch, the in-kernel transpose to put the batch dim first, the (YB, FB,
// S) output block and its transpose outside the kernel, and the sequential
// frame grid that revisited the accumulators.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "ring.cuh"

namespace {

using namespace solex_ring;
using namespace solex_plans::fused_mxu;

constexpr int kWarps = kThreads / 32;
constexpr int kK = 4;                     // spectral columns per mma
constexpr int kChunks = 2;                // 16-byte chunks a thread owns
constexpr int kDead = -16;                // tap column of an absent shift

static_assert(kCap <= 8 * kChunks * kThreads, "a run fits the threads' chunks");

__device__ __forceinline__ void dmma_8x8x4(double& d0, double& d1, double a,
                                           double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

template <bool kBulk>
__global__ void __launch_bounds__(kThreads, 3)
fused_mxu_kernel(const uint16_t* __restrict__ frames,
                 const int32_t* __restrict__ ind_l,
                 const float* __restrict__ left_w, int32_t* __restrict__ sum,
                 int32_t* __restrict__ mx, uint16_t* __restrict__ disks,
                 int S, int F, int ih, int iw, int yb, int D, int fb, int fper,
                 int disk_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r = lane >> 2;     // A row (frame) and B column (shift)
  const int c = lane & 3;      // A column and B row (spectral column)
  const int y0 = blockIdx.x * yb;
  const int fs = blockIdx.y * fper;            // a multiple of kSplitFrames
  const int fe = min(F, fs + fper);
  const int rows = min(yb, ih - y0);
  const int n = rows * iw;                     // run length of a frame
  const int nch = (n + 7) / 8;
  const int nsg = (S + kN - 1) / kN;
  const size_t fst = frame_stride(yb * iw);

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + kBarBytes;
  uint16_t* tile =
      reinterpret_cast<uint16_t*>(ring + (size_t)D * kM * fst);  // [S][yb][fb]
  double* wsm = reinterpret_cast<double*>(
      reinterpret_cast<unsigned char*>(tile) +
      align16(2 * (size_t)S * yb * fb));                    // [yb][w, 1 - w]
  int2* win = reinterpret_cast<int2*>(wsm + 2 * (size_t)yb);  // [yb][nsg]
  int32_t* lsm = reinterpret_cast<int32_t*>(win + (size_t)yb * nsg);

  // once a block: the tap column of every (row, shift group, shift) ...
  for (int j = tid; j < yb * nsg * kN; j += kThreads) {
    const int item = j / kN;
    const int yl = item / nsg;
    const int s = (item - yl * nsg) * kN + (j - item * kN);
    lsm[j] = yl < rows && s < S ? ind_l[(size_t)s * ih + y0 + yl] : kDead;
  }
  for (int j = tid; j < yb; j += kThreads) {
    const float w = j < rows ? left_w[y0 + j] : 0.0f;
    wsm[2 * j] = (double)w;
    wsm[2 * j + 1] = (double)__fsub_rn(1.0f, w);
  }
  if (kBulk && tid == 0) {
    for (int i = 0; i < D; ++i) mbar_init(bars + i, 1);
    fence_mbar_init();
  }
  __syncthreads();
  // ... and each group's K window: the columns from the lowest to the
  // highest in-range tap of its shifts
  for (int item = tid; item < rows * nsg; item += kThreads) {
    const int sg = item % nsg;
    int lo = INT_MAX, hi = -1;
    for (int q = 0; q < kN && sg * kN + q < S; ++q) {
      const int l = lsm[item * kN + q];
      lo = min(lo, min(max(l, 0), iw - 1));
      hi = max(hi, l >= iw - 1 ? iw - 1 : max(l + 1, 0));
    }
    win[item] = make_int2(lo, hi);
  }
  __syncthreads();

  const size_t fpix = (size_t)ih * iw;
  const uintptr_t run0_addr =
      reinterpret_cast<uintptr_t>(frames + (size_t)y0 * iw);  // frame 0's run
  const uintptr_t slab_end =
      reinterpret_cast<uintptr_t>(frames + (size_t)F * fpix);
  const int nst = (fe - fs + kM - 1) / kM;     // stages of this block

  // element offset of frame f's run in its granules (0 on the bulk path)
  auto head = [&](int f) -> int {
    return kBulk ? 0 : (int)(((run0_addr + 2 * (size_t)f * fpix) & 15) >> 1);
  };

  // fill stage j (frames fs + 8 j ...) into slot j % D
  auto fill = [&](int j) {
    const int f0 = fs + j * kM;
    fill_stage<kBulk>(ring + (size_t)(j % D) * kM * fst, fst, bars + j % D,
                      run0_addr, 2 * fpix, f0, j < nst ? min(kM, fe - f0) : 0,
                      (uint32_t)(n * 2), slab_end, tid);
  };

  SumMax<2, kChunks> acc;
  acc.clear();

  for (int j = 0; j < D - 1; ++j) fill(j);

  for (int k = 0; k < nst; ++k) {
    wait_stage<kBulk>(bars, k, D);
    __syncthreads();              // stage k landed; stage k - 1 was read
    fill(k + D - 1);              // into stage k - 1's slot

    const unsigned char* slot = ring + (size_t)(k % D) * kM * fst;
    const int f0 = fs + k * kM;
    const int mc = min(kM, fe - f0);
    for (int m = 0; m < mc; ++m)
      acc.add<kBulk>(slot + m * fst, 2 * head(f0 + m), n, nch, tid);

    // one warp per (row, shift group): D[8 frames, 8 shifts] over the window
    const int f = f0 + r;                      // A and D row of this lane
    for (int t = warp; t < rows * nsg; t += kWarps) {
      const int yl = t / nsg;
      const int sg = t - yl * nsg;
      const int l = lsm[t * kN + r];
      const int2 wd = win[t];
      const double bw = wsm[2 * yl];
      const double bw1 = wsm[2 * yl + 1];
      const uint16_t* arow =
          reinterpret_cast<const uint16_t*>(slot + r * fst) + head(f) +
          yl * iw;
      double d0 = 0.0, d1 = 0.0;
      for (int xb = wd.x & ~(kK - 1); xb <= wd.y; xb += kK) {
        const int x = xb + c;
        const double a = x < iw ? (double)arow[x] : 0.0;
        const double b = x == l ? bw : x - 1 == l ? bw1 : 0.0;
        dmma_8x8x4(d0, d1, a, b);
      }
      if (f < fe) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int so = sg * kN + 2 * c + i;  // D column of this lane
          if (so < S) {
            float v = __double2float_rn(i ? d1 : d0);
            v = fminf(fmaxf(v, 0.0f), 65535.0f);
            tile[((size_t)so * yb + yl) * fb + (f - fs) % fb] =
                (uint16_t)(int)v;
          }
        }
      }
    }

    // write the staged disks every fb frames (8 divides fb)
    const int fl = f0 + mc - 1;
    if ((fl - fs + 1) % fb == 0 || fl == fe - 1) {  // the same for all threads
      __syncthreads();
      const int fb0 = fl - (fl - fs) % fb;
      const int ng = fb / 8;
      for (int q = tid; q < S * rows * ng; q += kThreads) {
        const int g = q % ng;
        const int rr = q / ng;
        const int s = rr / rows;
        const int yl = rr - s * rows;
        const int fq = fb0 + 8 * g;
        const int cnt = min(8, fe - fq);
        if (cnt <= 0) continue;
        const uint16_t* src = tile + ((size_t)s * yb + yl) * fb + 8 * g;
        uint16_t* dst = disks + ((size_t)s * ih + y0 + yl) * F + fq;
        if (cnt == 8 && disk_vec) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int i = 0; i < cnt; ++i) dst[i] = src[i];
        }
      }
    }
  }

  acc.merge(sum + (size_t)y0 * iw, mx + (size_t)y0 * iw, n, nch, tid);
}

struct Launch {
  Plan plan;
  int blocks_per_sm, fper;
  dim3 grid;
};

template <bool kBulk>
cudaError_t configure(int F, int ih, Launch* L) {
  int sms = 0;
  const cudaError_t err = block_slots(fused_mxu_kernel<kBulk>, L->plan.smem,
                                      &L->blocks_per_sm, &sms);
  if (err != cudaSuccess) return err;
  const long long ny = (ih + L->plan.yb - 1) / L->plan.yb;
  L->fper = frames_per_block(ny, (long long)L->blocks_per_sm * sms, F);
  L->grid = dim3((unsigned)ny, (unsigned)((F + L->fper - 1) / L->fper));
  return cudaSuccess;
}

cudaError_t configure(uintptr_t ptr, int S, int F, int ih, int iw,
                      Launch* L) {
  if (iw < 2 || iw > kCap || S < 1 || F < 1 || ih < 1 ||
      !make_plan(ptr, S, ih, iw, &L->plan))
    return cudaErrorInvalidValue;
  return L->plan.bulk ? configure<true>(F, ih, L) : configure<false>(F, ih, L);
}

}  // namespace

// frames: (F, ih, iw) u16, C-contiguous, normalised orientation, with
// 2 <= iw <= 3072 (a block holds whole rows); ind_l: (S, ih) i32; left_w:
// (ih,) f32.  Outputs: sum, mx (ih, iw) i32, zeroed here on the stream;
// disks (S, ih, F) u16.  F <= 32767 keeps the int32 sum exact.
extern "C" int solex_shg_fused_mxu(const uint16_t* frames, const int32_t* ind_l,
                                   const float* left_w, int32_t* sum,
                                   int32_t* mx, uint16_t* disks, int S, int F,
                                   int ih, int iw, void* stream) {
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
    fused_mxu_kernel<true><<<L.grid, kThreads, p.smem, st>>>(
        frames, ind_l, left_w, sum, mx, disks, S, F, ih, iw, p.yb, p.D, p.fb,
        L.fper, disk_vec);
  else
    fused_mxu_kernel<false><<<L.grid, kThreads, p.smem, st>>>(
        frames, ind_l, left_w, sum, mx, disks, S, F, ih, iw, p.yb, p.D, p.fb,
        L.fper, disk_vec);
  return (int)cudaGetLastError();
}

// The launch geometry solex_shg_fused_mxu would use for these arguments,
// into out[10]: bulk path (1) or element path (0), yb, D, fb, bytes between
// two frames of a stage, shared bytes a block, blocks an SM holds, grid x,
// y, frames per block.
extern "C" int solex_shg_fused_mxu_plan(const uint16_t* frames, int S, int F,
                                        int ih, int iw, int* out) {
  Launch L;
  const cudaError_t err =
      configure(reinterpret_cast<uintptr_t>(frames), S, F, ih, iw, &L);
  if (err != cudaSuccess) return (int)err;
  const Plan& p = L.plan;
  const int v[10] = {p.bulk, p.yb, p.D, p.fb,
                     (int)frame_stride(p.yb * iw), (int)p.smem,
                     L.blocks_per_sm, (int)L.grid.x, (int)L.grid.y, L.fper};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}
