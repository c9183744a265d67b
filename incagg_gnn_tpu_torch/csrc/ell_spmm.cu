// Kernel B: ELL gather-multiply-reduce, out[r] = sum_k vals[r,k] * x[cols[r,k]].
//
// Replaces incagg_gnn_tpu/ops/pallas_spmm.py::pallas_spmm_ell_vmem, the Pallas
// blueprint whose in-kernel gather never lowered on the TPU (the JAX package
// computes the same function in XLA, ops/ell.py::_ell_sum).  Here it is the
// kernel of the hybrid ELL core, of every extension level and of the
// transposed backward.  cols [R, K] int32, vals [R, K] f32, x [C, D] f32,
// out [R, D] f32; any R (the Pallas version needed R % block_rows == 0).
//
// Bound.  Memory: each slot reads one x row (D*4 bytes, scattered) against
// 2*D flops, far below the card's flop/byte balance.  Design: one warp per
// (output row, 128-column chunk).  The warp reads 32 slots' (col, val) pairs
// with one coalesced load and broadcasts them with shuffles, then each lane
// gathers 16 contiguous bytes (float4) of each x row, so a warp moves a full
// 512-byte row chunk per slot, and accumulates in f32 registers.  The sum
// runs over k in order, like the reference; there are no atomics and no
// [R, K, D] intermediate in device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kChunk = 128;  // columns per warp: 32 lanes x 4

template <bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_spmm_kernel(const int32_t* __restrict__ cols, const float* __restrict__ vals,
                const float* __restrict__ x, float* __restrict__ out,
                int64_t R, int K, int D) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;  // uniform across the warp
  const int c0 = blockIdx.y * kChunk;
  const int32_t* cr = cols + r * K;
  const float* vr = vals + r * K;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int kb = 0; kb < K; kb += 32) {
    const int n = min(32, K - kb);
    const int32_t c = lane < n ? cr[kb + lane] : 0;
    const float v = lane < n ? vr[kb + lane] : 0.f;
    for (int j = 0; j < n; ++j) {
      const int64_t cj = __shfl_sync(0xffffffffu, c, j);
      const float vj = __shfl_sync(0xffffffffu, v, j);
      const float* xr = x + cj * D;
      if (kVec) {
        const int d = c0 + lane * 4;
        if (d < D) {
          const float4 xv = *reinterpret_cast<const float4*>(xr + d);
          acc[0] = fmaf(vj, xv.x, acc[0]);
          acc[1] = fmaf(vj, xv.y, acc[1]);
          acc[2] = fmaf(vj, xv.z, acc[2]);
          acc[3] = fmaf(vj, xv.w, acc[3]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int d = c0 + lane + 32 * q;
          if (d < D) acc[q] = fmaf(vj, xr[d], acc[q]);
        }
      }
    }
  }

  float* orow = out + r * D;
  if (kVec) {
    const int d = c0 + lane * 4;
    if (d < D)
      *reinterpret_cast<float4*>(orow + d) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int d = c0 + lane + 32 * q;
      if (d < D) orow[d] = acc[q];
    }
  }
}

}  // namespace

extern "C" int ell_spmm_f32(const void* cols, const void* vals, const void* x,
                            void* out, int64_t R, int K, int D, void* stream) {
  if (R <= 0 || K < 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((R + kWarpsPerBlock - 1) / kWarpsPerBlock),
                  (unsigned)((D + kChunk - 1) / kChunk));
  const dim3 block(kWarpsPerBlock * 32);
  // 16-byte row loads need D % 4 == 0 and 16-byte aligned base pointers
  const bool vec = D % 4 == 0 && ((uintptr_t)x % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0);
  if (vec)
    ell_spmm_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int32_t*)cols, (const float*)vals, (const float*)x, (float*)out,
        R, K, D);
  else
    ell_spmm_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int32_t*)cols, (const float*)vals, (const float*)x, (float*)out,
        R, K, D);
  return (int)cudaGetLastError();
}
