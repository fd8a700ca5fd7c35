// Kernel B3: multi-shift spectral-line reconstruction (pass B) on the raw
// SER layout, in ONE launch over every resident chunk of a scan.
//
// Replaces the Pallas kernel solex_ser_recon_en_tpu/ops/pallas_recon.py:_kernel
// (_recon_pallas), and on the main path the one-hot f32 matmul of
// solex_ser_recon_en_tpu/ops/fused.py:_recon_raw.
//
//   out[s, y, frame_offset + f] =
//       u16(clip(w[y] * x(f, y, l) + (1 - w[y]) * x(f, y, l + 1), 0, 65535)),
//   l = ind_l[s, y]
//
// with x(f, y, c) = raw_f[c, W-1-y] when the scan is stored wide (rotate:
// the normalised frame is np.rot90 of the raw one) and raw_f[y, c]
// otherwise, times 256 for 8-bit input.  The kernel clips l to [0, iw-2]
// (build_shift_indices already does; reference solex_util.py:117-118), so
// both taps are always inside the frame.
//
// The frames come as K separate (n_k, H, W) allocations (the feeder's
// chunks, io/feeder.py), every one but the last holding the same C frames:
// frame f of the launch lies in chunk f / C at local frame f % C.  Their
// base pointers travel in a __grid_constant__ table of at most kMaxChunks
// entries (2 KB of the 4 KB kernel-parameter space), so no device table,
// no upload and no host sync.  The disks go straight into the caller's
// (S, ih, out_frames) tensor at frame_offset: no per-chunk disks, no cat.
//
// What bounds it on an H100: bytes.  Each output needs two 2-byte taps and
// one 2-byte store; there are two multiplies and one add per output.  On
// the bench scan (25 chunks of 81 frames, S = 2) one launch moves ~49 MB,
// 0.015 ms at 3.35 TB/s; launched once per chunk it paid a launch and a
// ragged last frame tile (17 of 32 frames) 25 times.  Here the frame tiles
// of all chunks are flattened into one grid axis, so only the scan's last
// tile is ragged.  The taps of one (s, f) lie along the spatial axis y,
// which is the contiguous axis of a wide-stored frame, while the output is
// contiguous along f.  A block therefore reads a 32 (y) x 32 (f) tile with
// threads walking y (coalesced reads of raw rows; all loads of a thread
// issued before any use), transposes it through shared memory, and writes
// with threads walking f (coalesced stores).  On the TPU the kernel
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
constexpr int kPer = kTile / kRows;  // frames per thread
constexpr int kMaxChunks = 256;

struct ChunkTable {
  const void* base[kMaxChunks];
};

template <typename T, bool kRotate>
__global__ void __launch_bounds__(kTile* kRows)
    recon_chunks_kernel(const __grid_constant__ ChunkTable table,
                        int chunk_frames, int F, int H, int W,
                        const int32_t* __restrict__ ind_l,
                        const float* __restrict__ left_w,
                        uint16_t* __restrict__ out, int out_frames,
                        int frame_offset, int ih, int iw, float scale) {
  __shared__ uint16_t tile[kTile][kTile + 1];  // [f_local][y_local]
  const int s = blockIdx.z;
  const int y0 = blockIdx.y * kTile;
  const int f0 = blockIdx.x * kTile;
  const int y = y0 + threadIdx.x;
  if (y < ih) {
    const int l = min(max(ind_l[(size_t)s * ih + y], 0), iw - 2);
    const float w = left_w[y];
    const float wr = __fsub_rn(1.0f, w);
    const size_t off0 = kRotate ? (size_t)l * W + (W - 1 - y)
                                : (size_t)y * W + l;
    const size_t off1 = kRotate ? off0 + W : off0 + 1;
    const size_t frame_elems = (size_t)H * W;
    float x0[kPer], x1[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int f = f0 + threadIdx.y + u * kRows;
      x0[u] = x1[u] = 0.0f;
      if (f < F) {
        const int k = f / chunk_frames;  // the same for the whole warp
        const T* frame = static_cast<const T*>(table.base[k]) +
                         (size_t)(f - k * chunk_frames) * frame_elems;
        x0[u] = (float)frame[off0];
        x1[u] = (float)frame[off1];
      }
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const float a = __fmul_rn(x0[u], scale);
      const float b = __fmul_rn(x1[u], scale);
      float v = __fadd_rn(__fmul_rn(w, a), __fmul_rn(wr, b));
      v = fminf(fmaxf(v, 0.0f), 65535.0f);
      tile[threadIdx.y + u * kRows][threadIdx.x] = (uint16_t)(int)v;
    }
  }
  __syncthreads();
  const int f = f0 + threadIdx.x;
  if (f < F) {
    uint16_t* dst = out + (size_t)s * ih * out_frames + frame_offset + f;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int yy = y0 + threadIdx.y + u * kRows;
      if (yy < ih) dst[(size_t)yy * out_frames] = tile[threadIdx.x][yy - y0];
    }
  }
}

template <typename T>
void launch(const ChunkTable& table, int chunk_frames, const int32_t* ind_l,
            const float* left_w, uint16_t* out, int S, int F, int H, int W,
            int ih, int out_frames, int frame_offset, int rotate, float scale,
            cudaStream_t stream) {
  const dim3 block(kTile, kRows);
  const dim3 grid((F + kTile - 1) / kTile, (ih + kTile - 1) / kTile, S);
  const int iw = rotate ? H : W;
  if (rotate) {
    recon_chunks_kernel<T, true><<<grid, block, 0, stream>>>(
        table, chunk_frames, F, H, W, ind_l, left_w, out, out_frames,
        frame_offset, ih, iw, scale);
  } else {
    recon_chunks_kernel<T, false><<<grid, block, 0, stream>>>(
        table, chunk_frames, F, H, W, ind_l, left_w, out, out_frames,
        frame_offset, ih, iw, scale);
  }
}

}  // namespace

// The most chunks one launch takes (the wrapper groups beyond it).
extern "C" int solex_recon_max_chunks() { return kMaxChunks; }

// bases: host array of K device pointers to C-contiguous (n_k, H, W) u16
// (elem_bytes 2) or u8 (elem_bytes 1) chunks, n_k = chunk_frames for every
// chunk but the last; F = sum n_k.  ind_l: (S, ih) i32; left_w: (ih,) f32;
// out: (S, ih, out_frames) u16, frames [frame_offset, frame_offset + F)
// written.
extern "C" int solex_recon_chunks(const uint64_t* bases, int K,
                                  int chunk_frames, int elem_bytes,
                                  const int32_t* ind_l, const float* left_w,
                                  uint16_t* out, int S, int F, int H, int W,
                                  int ih, int out_frames, int frame_offset,
                                  int rotate, int upscale, void* stream) {
  if (K < 1 || K > kMaxChunks || chunk_frames < 1) {
    return (int)cudaErrorInvalidValue;
  }
  ChunkTable table = {};
  for (int k = 0; k < K; ++k) {
    table.base[k] = reinterpret_cast<const void*>(bases[k]);
  }
  const float scale = upscale ? 256.0f : 1.0f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1) {
    launch<uint8_t>(table, chunk_frames, ind_l, left_w, out, S, F, H, W, ih,
                    out_frames, frame_offset, rotate, scale, st);
  } else {
    launch<uint16_t>(table, chunk_frames, ind_l, left_w, out, S, F, H, W, ih,
                     out_frames, frame_offset, rotate, scale, st);
  }
  return (int)cudaGetLastError();
}
