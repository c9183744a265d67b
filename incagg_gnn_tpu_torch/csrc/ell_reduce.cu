// Kernel C: weighted K-reduction of pre-gathered rows,
// out[r, :] = sum_k vals[r, k] * g[r, k, :].
//
// Replaces incagg_gnn_tpu/ops/pallas_spmm.py::pallas_ell_reduce (body
// _reduce_kernel), the multiply + K-reduction stage of the ELL aggregation
// with the gather left outside.  No path of either package calls it: kernel B
// (ell_spmm.cu) fuses the gather, so it never materialises g.  g [R, K, D]
// f32 contiguous, vals [R, K] f32, out [R, D] f32; any R and any D (the
// Pallas version needed R % block_rows == 0).
//
// Bound.  Memory: every element of g is read once for one FMA, so the
// kernel is a streaming pass over R*K*D*4 bytes.  Design: ell_spmm.cu's
// layout minus the gather.  One warp per (row, 128-column chunk); the warp
// loads 32 of the row's weights with one coalesced load and broadcasts them
// with shuffles; each lane reads 16 contiguous bytes (float4) of each slot's
// row chunk, so a warp streams a contiguous 512-byte chunk per slot, and
// sums in f32 registers over k in order.  No atomics, no shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kChunk = 128;  // columns per warp: 32 lanes x 4

template <bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_reduce_kernel(const float* __restrict__ g, const float* __restrict__ vals,
                  float* __restrict__ out, int64_t R, int K, int D) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;  // uniform across the warp
  const int c0 = blockIdx.y * kChunk;
  const float* gr = g + r * K * (int64_t)D;
  const float* vr = vals + r * K;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int kb = 0; kb < K; kb += 32) {
    const int n = min(32, K - kb);
    const float v = lane < n ? vr[kb + lane] : 0.f;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float vj = __shfl_sync(0xffffffffu, v, j);
      const float* row = gr + (int64_t)(kb + j) * D;
      if (kVec) {
        const int d = c0 + lane * 4;
        if (d < D) {
          const float4 gv = __ldg(reinterpret_cast<const float4*>(row + d));
          acc[0] = fmaf(vj, gv.x, acc[0]);
          acc[1] = fmaf(vj, gv.y, acc[1]);
          acc[2] = fmaf(vj, gv.z, acc[2]);
          acc[3] = fmaf(vj, gv.w, acc[3]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int d = c0 + lane + 32 * q;
          if (d < D) acc[q] = fmaf(vj, __ldg(row + d), acc[q]);
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

extern "C" int ell_reduce_f32(const void* g, const void* vals, void* out,
                              int64_t R, int K, int D, void* stream) {
  if (R <= 0 || K < 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((R + kWarpsPerBlock - 1) / kWarpsPerBlock),
                  (unsigned)((D + kChunk - 1) / kChunk));
  const dim3 block(kWarpsPerBlock * 32);
  // 16-byte row loads need D % 4 == 0 and 16-byte aligned base pointers
  const bool vec = D % 4 == 0 && ((uintptr_t)g % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0);
  if (vec)
    ell_reduce_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)g, (const float*)vals, (float*)out, R, K, D);
  else
    ell_reduce_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)g, (const float*)vals, (float*)out, R, K, D);
  return (int)cudaGetLastError();
}
