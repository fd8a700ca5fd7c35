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
// What bounds it on an H100: bytes.  Every frame byte has to be read once
// (2.458 GB for the 2000 x 2048 x 300 bench slab, ~0.73 ms at 3.35 TB/s);
// the disks are S x ih x F x 2 B (16.4 MB at S = 2) and the two (ih, iw)
// accumulators are small.  The design reads each frame byte exactly once:
//
// - A block owns `yb` rows x `xw` columns (all of iw when it fits, so the
//   block's part of a frame is one contiguous run and the loads coalesce)
//   and a range of frames.  Each thread keeps the sum and max of its kPer
//   elements in registers across the frames.
// - The rows just loaded are also written to a double-buffered copy in
//   shared memory; after one barrier per frame, one thread per (s, y) reads
//   its two taps from there, not from device memory.
// - Disk values are staged in a (S, yb, 32-frame) shared tile and written
//   32 frames at a time, so the stores are contiguous along f.
// - Frames are split over blockIdx.z so that the ih / yb row tiles fill the
//   card; partial sums and maxima merge with integer atomicAdd / atomicMax
//   into the zeroed int32 outputs, which is exact in any block order.
//
// Rows wider than one block's registers (iw > 2048) are split over
// blockIdx.x; each column chunk loads one column more than it accumulates,
// and a shift's taps belong to the chunk that holds its left tap.
//
// Not carried over from the TPU kernel: the 128-lane window and its
// host-side selector, the iota-compare mask scratch with its float32 copy
// of the tile (a gather needs neither), the padding to the Mosaic lane rule,
// and the sequential frame grid that revisited the accumulators.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                    // elements per thread per frame
constexpr int kCap = kThreads * kPer;      // elements per block per frame
constexpr int kFB = 32;                    // frames per disk store
constexpr int kMaxRows = 8;
constexpr size_t kDefaultSmem = 48 * 1024;

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__host__ __device__ inline size_t buf_bytes(int yb, int xw) {
  return align16(2 * sizeof(uint16_t) * (size_t)yb * (xw + 1));
}

__host__ __device__ inline size_t tile_bytes(int S, int yb) {
  return sizeof(uint16_t) * (size_t)S * yb * kFB;
}

size_t smem_bytes(int S, int yb, int xw) {
  return buf_bytes(yb, xw) + tile_bytes(S, yb) +
         sizeof(int32_t) * (size_t)S * yb + sizeof(float) * yb;
}

__global__ void __launch_bounds__(kThreads)
fused_kernel(const uint16_t* __restrict__ frames,
             const int32_t* __restrict__ ind_l,
             const float* __restrict__ left_w, int32_t* __restrict__ sum,
             int32_t* __restrict__ mx, uint16_t* __restrict__ disks, int S,
             int F, int ih, int iw, int yb, int xw, int fper) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* buf = reinterpret_cast<uint16_t*>(smem);         // [2][yb*(xw+1)]
  uint16_t* tile = reinterpret_cast<uint16_t*>(smem + buf_bytes(yb, xw));
  int32_t* loc = reinterpret_cast<int32_t*>(
      smem + buf_bytes(yb, xw) + tile_bytes(S, yb));         // [S][yb]
  float* wsm = reinterpret_cast<float*>(loc + (size_t)S * yb);  // [yb]

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * xw;
  const int y0 = blockIdx.y * yb;
  const int fs = blockIdx.z * fper;          // a multiple of kFB
  const int fe = min(F, fs + fper);
  const int rows = min(yb, ih - y0);
  const int cols = min(xw, iw - x0);         // columns accumulated here
  const int lcols = min(xw + 1, iw - x0);    // columns loaded (+ right tap)
  const int n = rows * lcols;
  const int bstride = yb * (xw + 1);

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

  int goff[kPer];
  int32_t acc_s[kPer], acc_m[kPer];
  unsigned load_mask = 0, acc_mask = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = tid + k * kThreads;
    acc_s[k] = 0;
    acc_m[k] = 0;
    goff[k] = 0;
    if (e < n) {
      const int yl = e / lcols;
      const int xl = e - yl * lcols;
      goff[k] = yl * iw + xl;
      load_mask |= 1u << k;
      if (xl < cols) acc_mask |= 1u << k;
    }
  }
  __syncthreads();

  const uint16_t* base = frames + (size_t)y0 * iw + x0;
  const size_t fstride = (size_t)ih * iw;
  for (int f = fs; f < fe; ++f) {
    const uint16_t* src = base + (size_t)f * fstride;
    uint16_t* b = buf + (f & 1) * bstride;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (load_mask >> k & 1u) {
        const uint16_t v = src[goff[k]];
        b[tid + k * kThreads] = v;
        if (acc_mask >> k & 1u) {
          acc_s[k] += v;
          acc_m[k] = max(acc_m[k], (int32_t)v);
        }
      }
    }
    __syncthreads();

    const int fl = (f - fs) & (kFB - 1);
    for (int j = tid; j < S * rows; j += kThreads) {
      const int s = j / rows;
      const int yl = j - s * rows;
      const int c = loc[s * yb + yl];
      if (c >= 0) {
        const uint16_t* row = b + yl * lcols;
        const float x0f = (float)row[c];
        const float x1f = (float)row[c + 1];
        const float w = wsm[yl];
        float v = __fadd_rn(__fmul_rn(w, x0f),
                            __fmul_rn(__fsub_rn(1.0f, w), x1f));
        v = fminf(fmaxf(v, 0.0f), 65535.0f);
        tile[(s * yb + yl) * kFB + fl] = (uint16_t)(int)v;
      }
    }

    if (fl == kFB - 1 || f == fe - 1) {      // the same f for every thread
      __syncthreads();
      const int fb0 = f - fl;
      for (int j = tid; j < S * rows * kFB; j += kThreads) {
        const int ff = j & (kFB - 1);
        const int r = j / kFB;
        const int s = r / rows;
        const int yl = r - s * rows;
        if (ff <= fl && loc[s * yb + yl] >= 0)
          disks[((size_t)s * ih + y0 + yl) * F + fb0 + ff] =
              tile[(s * yb + yl) * kFB + ff];
      }
      __syncthreads();
    }
  }

  const size_t obase = (size_t)y0 * iw + x0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (acc_mask >> k & 1u) {
      atomicAdd(&sum[obase + goff[k]], acc_s[k]);
      atomicMax(&mx[obase + goff[k]], acc_m[k]);
    }
  }
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
  const size_t acc = (size_t)ih * iw * sizeof(int32_t);
  cudaError_t err = cudaMemsetAsync(sum, 0, acc, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(mx, 0, acc, st);
  if (err != cudaSuccess) return (int)err;

  int xw, yb;
  if (iw <= kCap) {
    xw = iw;
    yb = min(kMaxRows, kCap / iw);
  } else {
    xw = kCap - 1;    // + the right-tap column = kCap loaded columns
    yb = 1;
  }
  while (yb > 1 && smem_bytes(S, yb, xw) > kDefaultSmem) --yb;
  const size_t smem = smem_bytes(S, yb, xw);
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }

  int dev = 0, sms = 132;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int nx = (iw + xw - 1) / xw;
  const int ny = (ih + yb - 1) / yb;
  const int nfb = (F + kFB - 1) / kFB;
  // enough frame splits for ~8 blocks per SM
  int split = (8 * sms + nx * ny - 1) / (nx * ny);
  split = max(1, min(split, nfb));
  const int fper = kFB * ((nfb + split - 1) / split);
  split = (F + fper - 1) / fper;

  const dim3 grid(nx, ny, split);
  fused_kernel<<<grid, kThreads, smem, st>>>(frames, ind_l, left_w, sum, mx,
                                             disks, S, F, ih, iw, yb, xw,
                                             fper);
  return (int)cudaGetLastError();
}
