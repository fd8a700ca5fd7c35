// Kernel B3: multi-shift spectral-line reconstruction (pass B) on the raw
// SER layout.
//
// Replaces the Pallas kernel solex_ser_recon_en_tpu/ops/pallas_recon.py:_kernel
// (_recon_pallas), and on the main path the one-hot f32 matmul of
// solex_ser_recon_en_tpu/ops/fused.py:_recon_raw.
//
//   out[s, y, f] = u16(clip(w[y] * x(f, y, l) + (1 - w[y]) * x(f, y, l + 1),
//                           0, 65535)),       l = ind_l[s, y]
//
// with x(f, y, c) = raw[f, c, W-1-y] when the scan is stored wide (rotate:
// the normalised frame is np.rot90 of the raw one) and raw[f, y, c]
// otherwise, times 256 for 8-bit input.  The kernel clips l to [0, iw-2]
// (build_shift_indices already does; reference solex_util.py:117-118), so
// both taps are always inside the frame.
//
// What bounds it on an H100: bytes.  Each output needs two 2-byte taps and
// one 2-byte store; there are two multiplies and one add per output.  The
// taps of one (s, f) lie along the spatial axis y, which is the contiguous
// axis of a wide-stored frame, while the output is contiguous along f.  A
// block therefore reads a 32 (y) x 32 (f) tile with threads walking y
// (coalesced reads of raw rows), transposes it through shared memory, and
// writes with threads walking f (coalesced stores).  On the TPU the kernel
// extracted the taps with an iota-compare mask and a lane reduction because
// it has no gather; here two indexed loads replace the S x iw one-hot
// contraction and its float32 copy of the slab.
//
// Arithmetic: no FMA (the file is also built with --fmad=false), each
// product and the sum rounded separately, exactly as the plain version
// (ops/recon.py:recon_plain) and the JAX package's gather-lerp
// (solex_ser_recon_en_tpu/ops/fused.py:_recon_raw_lerp).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;

template <typename T, bool kRotate>
__global__ void recon_kernel(const T* __restrict__ raw,
                             const int32_t* __restrict__ ind_l,
                             const float* __restrict__ left_w,
                             uint16_t* __restrict__ out, int F, int H, int W,
                             int ih, int iw, float scale) {
  __shared__ uint16_t tile[kTile][kTile + 1];  // [f_local][y_local]
  const int s = blockIdx.z;
  const int y0 = blockIdx.y * kTile;
  const int f0 = blockIdx.x * kTile;
  const int y = y0 + threadIdx.x;
  if (y < ih) {
    const int l = min(max(ind_l[(size_t)s * ih + y], 0), iw - 2);
    const float w = left_w[y];
    const float wr = __fsub_rn(1.0f, w);
    for (int j = threadIdx.y; j < kTile; j += kRows) {
      const int f = f0 + j;
      if (f >= F) break;
      const T* frame = raw + (size_t)f * H * W;
      float x0, x1;
      if (kRotate) {
        const int col = W - 1 - y;
        x0 = (float)frame[(size_t)l * W + col];
        x1 = (float)frame[(size_t)(l + 1) * W + col];
      } else {
        x0 = (float)frame[(size_t)y * W + l];
        x1 = (float)frame[(size_t)y * W + l + 1];
      }
      x0 = __fmul_rn(x0, scale);
      x1 = __fmul_rn(x1, scale);
      float v = __fadd_rn(__fmul_rn(w, x0), __fmul_rn(wr, x1));
      v = fminf(fmaxf(v, 0.0f), 65535.0f);
      tile[j][threadIdx.x] = (uint16_t)(int)v;
    }
  }
  __syncthreads();
  const int f = f0 + threadIdx.x;
  if (f < F) {
    for (int j = threadIdx.y; j < kTile; j += kRows) {
      const int yy = y0 + j;
      if (yy >= ih) break;
      out[((size_t)s * ih + yy) * F + f] = tile[threadIdx.x][j];
    }
  }
}

template <typename T>
void launch(const void* raw, const int32_t* ind_l, const float* left_w,
            uint16_t* out, int S, int F, int H, int W, int ih, int rotate,
            float scale, cudaStream_t stream) {
  const dim3 block(kTile, kRows);
  const dim3 grid((F + kTile - 1) / kTile, (ih + kTile - 1) / kTile, S);
  const T* src = static_cast<const T*>(raw);
  const int iw = rotate ? H : W;
  if (rotate) {
    recon_kernel<T, true><<<grid, block, 0, stream>>>(src, ind_l, left_w, out,
                                                      F, H, W, ih, iw, scale);
  } else {
    recon_kernel<T, false><<<grid, block, 0, stream>>>(src, ind_l, left_w, out,
                                                       F, H, W, ih, iw, scale);
  }
}

}  // namespace

// raw: (F, H, W) u16 (elem_bytes 2) or u8 (elem_bytes 1), C-contiguous.
// ind_l: (S, ih) i32; left_w: (ih,) f32; out: (S, ih, F) u16.
extern "C" int solex_recon(const void* raw, int elem_bytes,
                           const int32_t* ind_l, const float* left_w,
                           uint16_t* out, int S, int F, int H, int W, int ih,
                           int rotate, int upscale, void* stream) {
  const float scale = upscale ? 256.0f : 1.0f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1) {
    launch<uint8_t>(raw, ind_l, left_w, out, S, F, H, W, ih, rotate, scale, st);
  } else {
    launch<uint16_t>(raw, ind_l, left_w, out, S, F, H, W, ih, rotate, scale,
                     st);
  }
  return (int)cudaGetLastError();
}
