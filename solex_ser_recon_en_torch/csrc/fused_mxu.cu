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
// scratch.  A is read from the frame tile in shared memory; K past iw and
// frames past the block's range read as 0.0 (finite: NaN * 0 would be NaN).
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
// 0.29 ms at 67 TFLOP/s.  The design reads each frame byte exactly once:
//
// - A block owns `yb` whole rows (yb * iw <= 3072 elements, so the rows of
//   one frame are one contiguous run and the loads coalesce) and a range of
//   frames.  It walks the range 8 frames at a time: all 256 threads load
//   the 8 frames' rows into the shared tile, keeping the sum and max of
//   their fixed positions in registers, then after one barrier the warps
//   run the contractions from the tile.
// - Frames are split over blockIdx.y so that the row tiles fill the card;
//   partial sums and maxima merge with integer atomicAdd / atomicMax into
//   the zeroed int32 outputs, exact in any block order (as B1).
// - The tile's per-frame stride is padded so that the 8 frame rows of an A
//   fragment fall in distinct shared-memory banks.
//
// Not carried over from the TPU kernel: the (YB, S, iw) float32 comb
// scratch, the in-kernel transpose to put the batch dim first, the (YB, FB,
// S) output block and its transpose outside the kernel, and the sequential
// frame grid that revisited the accumulators.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kM = 8;                     // frames per mma tile
constexpr int kN = 8;                     // shifts per mma tile
constexpr int kK = 4;                     // spectral columns per mma
constexpr int kPer = 12;                  // tile positions per thread
constexpr int kCap = kThreads * kPer;     // positions (rows x iw) per block
constexpr int kMaxRows = 8;
constexpr size_t kDefaultSmem = 48 * 1024;

// per-frame stride (u16) of the shared tile: a multiple of 64 elements plus
// 8, i.e. 4 banks between frame rows, so an A fragment is conflict free
__host__ __device__ inline int tile_stride(int n) {
  return (n + 63) / 64 * 64 + 8;
}

__device__ __forceinline__ void dmma_8x8x4(double& d0, double& d1, double a,
                                           double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

__global__ void __launch_bounds__(kThreads)
fused_mxu_kernel(const uint16_t* __restrict__ frames,
                 const int32_t* __restrict__ ind_l,
                 const float* __restrict__ left_w, int32_t* __restrict__ sum,
                 int32_t* __restrict__ mx, uint16_t* __restrict__ disks,
                 int S, int F, int ih, int iw, int yb, int fper) {
  extern __shared__ __align__(16) uint16_t tile[];    // [kM][ts]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r = lane >> 2;     // A row (frame) and B column (shift)
  const int c = lane & 3;      // A column and B row (spectral column)
  const int y0 = blockIdx.x * yb;
  const int rows = min(yb, ih - y0);
  const int n = rows * iw;
  const int ts = tile_stride(yb * iw);
  const int fs = blockIdx.y * fper;            // a multiple of kM
  const int fe = min(F, fs + fper);
  const int nsg = (S + kN - 1) / kN;

  int32_t acc_s[kPer], acc_m[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    acc_s[k] = 0;
    acc_m[k] = 0;
  }

  const uint16_t* base = frames + (size_t)y0 * iw;
  const size_t fstride = (size_t)ih * iw;
  for (int f0 = fs; f0 < fe; f0 += kM) {
    __syncthreads();                           // the tile has been read
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int p = tid + k * kThreads;
      if (p < n) {
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          const uint16_t v =
              f0 + m < fe ? base[(size_t)(f0 + m) * fstride + p] : 0;
          tile[m * ts + p] = v;
          acc_s[k] += v;
          acc_m[k] = max(acc_m[k], (int32_t)v);
        }
      }
    }
    __syncthreads();

    for (int t = warp; t < rows * nsg; t += kWarps) {
      const int yl = t / nsg;
      const int sg = t - yl * nsg;
      const int y = y0 + yl;
      const int s = sg * kN + r;
      const bool live = s < S;
      const int l = live ? ind_l[(size_t)s * ih + y] : 0;
      const float w = left_w[y];
      const double bw = (double)w;
      const double bw1 = (double)__fsub_rn(1.0f, w);
      // the K window: chunks holding some live shift's in-range tap
      int lo = live ? min(max(l, 0), iw - 1) : INT_MAX;
      int hi = live ? min(max(l + 1, 0), iw - 1) : -1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      }
      const uint16_t* arow = tile + r * ts + yl * iw;
      double d0 = 0.0, d1 = 0.0;
      for (int xb = lo & ~(kK - 1); xb <= hi; xb += kK) {
        const int x = xb + c;
        const double a = x < iw ? (double)arow[x] : 0.0;
        const double b = !live ? 0.0 : x == l ? bw : x == l + 1 ? bw1 : 0.0;
        dmma_8x8x4(d0, d1, a, b);
      }
      const int f = f0 + r;                    // D row of this lane
      if (f < fe) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int so = sg * kN + 2 * c + i;  // D column of this lane
          if (so < S) {
            float v = __double2float_rn(i ? d1 : d0);
            v = fminf(fmaxf(v, 0.0f), 65535.0f);
            disks[((size_t)so * ih + y) * F + f] = (uint16_t)(int)v;
          }
        }
      }
    }
  }

  int32_t* sb = sum + (size_t)y0 * iw;
  int32_t* mb = mx + (size_t)y0 * iw;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int p = tid + k * kThreads;
    if (p < n) {
      atomicAdd(&sb[p], acc_s[k]);
      atomicMax(&mb[p], acc_m[k]);
    }
  }
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
  if (iw < 2 || iw > kCap || S < 1 || F < 1 || ih < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t acc = (size_t)ih * iw * sizeof(int32_t);
  cudaError_t err = cudaMemsetAsync(sum, 0, acc, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(mx, 0, acc, st);
  if (err != cudaSuccess) return (int)err;

  const int yb = min(min(kMaxRows, kCap / iw), ih);
  const size_t smem = sizeof(uint16_t) * kM * (size_t)tile_stride(yb * iw);
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(fused_mxu_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }

  int dev = 0, sms = 132;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int ny = (ih + yb - 1) / yb;
  const int ng = (F + kM - 1) / kM;
  // enough frame splits for ~8 blocks per SM
  int split = (8 * sms + ny - 1) / ny;
  split = max(1, min(split, ng));
  const int fper = kM * ((ng + split - 1) / split);
  split = (F + fper - 1) / fper;

  const dim3 grid(ny, split);
  fused_mxu_kernel<<<grid, kThreads, smem, st>>>(frames, ind_l, left_w, sum,
                                                 mx, disks, S, F, ih, iw, yb,
                                                 fper);
  return (int)cudaGetLastError();
}
