// Kernel B4: horizontal two-tap resample of the circularisation warp.
//
// Replaces the Pallas kernel solex_ser_recon_en_tpu/ops/warp_fast.py:_hkernel
// (_hresample).  The warp matrices of the pipeline have second row
// [0, 1, ty], so the bilinear warp splits into a vertical row lerp (plain
// torch, ops/warp_fast.py) and this per-row horizontal pass:
//
//   out[k, r, x] = (V[k, r, loc] * w0 + V[k, r, loc + 1] * w1) + cadd[k, r, x]
//
// with loc, w0, w1 shared by every image of the batch (one matrix) and the
// cval term cadd per image.  A tap outside [0, Wp) contributes exactly 0,
// as the unmatched iota of the TPU kernel does; such taps carry zero weight
// anyway, the guard only keeps the load inside the row.
//
// What bounds it on an H100: bytes.  Per output it reads one i32 index,
// three f32 weights and two f32 taps from a row that stays in L1/L2, and
// stores one f32; two multiplies and two adds.  Threads of a block walk x
// along one output row, so index/weight reads and stores are coalesced and
// the taps of neighbouring threads fall on neighbouring source columns.
// On the TPU the taps were pulled out of a lane-aligned VMEM window with a
// one-hot compare and a reduction because the TPU has no gather; here the
// card's indexed loads do it directly, so no window is needed.
//
// Arithmetic: no FMA; (p0 + p1) + cadd in that order, each step rounded,
// which is the order of the TPU kernel's masked sum followed by + cadd.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void hresample_kernel(const float* __restrict__ V,
                                 const int32_t* __restrict__ loc,
                                 const float* __restrict__ w0,
                                 const float* __restrict__ w1,
                                 const float* __restrict__ cadd,
                                 float* __restrict__ out, int H, int Wp,
                                 int OW) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int r = blockIdx.y;
  const int k = blockIdx.z;
  if (x >= OW) return;
  const size_t i = (size_t)r * OW + x;
  const size_t o = ((size_t)k * H + r) * OW + x;
  const float* row = V + ((size_t)k * H + r) * Wp;
  const int l = loc[i];
  float p0 = 0.0f, p1 = 0.0f;
  if (l >= 0 && l < Wp) p0 = __fmul_rn(row[l], w0[i]);
  if (l + 1 >= 0 && l + 1 < Wp) p1 = __fmul_rn(row[l + 1], w1[i]);
  out[o] = __fadd_rn(__fadd_rn(p0, p1), cadd[o]);
}

}  // namespace

// V: (K, H, Wp) f32; loc: (H, OW) i32; w0, w1: (H, OW) f32;
// cadd: (K, H, OW) f32; out: (K, H, OW) f32.  All C-contiguous.
extern "C" int solex_hresample(const float* V, const int32_t* loc,
                               const float* w0, const float* w1,
                               const float* cadd, float* out, int K, int H,
                               int Wp, int OW, void* stream) {
  const dim3 grid((OW + kThreads - 1) / kThreads, H, K);
  hresample_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      V, loc, w0, w1, cadd, out, H, Wp, OW);
  return (int)cudaGetLastError();
}
