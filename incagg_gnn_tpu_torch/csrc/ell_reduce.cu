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
// kernel is a streaming pass over R*K*D*4 bytes, and what holds it below the
// card's memory rate is the number of loads in flight.  Design: ell_spmm.cu's
// layout minus the gather, with every lane keeping sixteen independent
// 16-byte loads of g in flight: two float4 of each of eight slots, issued
// before their FMAs.  A row's chunk of columns belongs to a warp (D > 128:
// 256 columns, so that a warp streams a whole 1 KB row of a D = 256 table per
// slot) or to half a warp (D <= 128: a warp takes two rows of 128 columns).
// The group loads its row's weights 32 or 16 at a time with one coalesced
// load and broadcasts them with shuffles; the sums stay in f32 registers in k
// order.  No atomics, no shared memory.  A scalar path (one warp per row and 128
// columns) takes D not a multiple of 4 or a misaligned g.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kChunk = 128;   // columns per warp on the scalar path
constexpr int kVecs = 2;      // float4 per lane and slot on the vector path
constexpr int kInFlight = 8;  // slots whose loads are issued together

// kRows rows per warp: 32 / kRows lanes per row, the group covering
// 32 / kRows * 4 * kVecs columns of its row (256 or 128)
template <int kRows>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_reduce_vec_kernel(const float* __restrict__ g, const float* __restrict__ vals,
                      float* __restrict__ out, int64_t R, int K, int D) {
  constexpr int kLanes = 32 / kRows;
  const int lane = threadIdx.x & 31;
  const int l = lane % kLanes;
  const int64_t r0 = ((int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * kRows;
  if (r0 >= R) return;  // uniform across the warp
  const int64_t r = r0 + lane / kLanes;
  const bool live_row = r < R;  // the second half of the last warp may have none
  const int64_t rr = live_row ? r : R - 1;
  const int c0 = blockIdx.y * kLanes * 4 * kVecs;
  const float* gr = g + rr * K * (int64_t)D;
  const float* vr = vals + rr * K;
  int dv[kVecs];
  bool live[kVecs];
#pragma unroll
  for (int p = 0; p < kVecs; ++p) {
    dv[p] = c0 + p * kLanes * 4 + l * 4;
    live[p] = dv[p] < D;
  }
  float acc[kVecs][4] = {};

  for (int kb = 0; kb < K; kb += kLanes) {
    const int n = min(kLanes, K - kb);
    const float w = l < n ? vr[kb + l] : 0.f;
    int j = 0;
    for (; j + kInFlight <= n; j += kInFlight) {
      float wj[kInFlight];
      float4 gv[kInFlight][kVecs];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        wj[u] = __shfl_sync(0xffffffffu, w, j + u, kLanes);
        const float* row = gr + (int64_t)(kb + j + u) * D;
#pragma unroll
        for (int p = 0; p < kVecs; ++p)
          gv[u][p] = live[p] ? __ldg(reinterpret_cast<const float4*>(row + dv[p]))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
#pragma unroll
        for (int p = 0; p < kVecs; ++p) {
          acc[p][0] = fmaf(wj[u], gv[u][p].x, acc[p][0]);
          acc[p][1] = fmaf(wj[u], gv[u][p].y, acc[p][1]);
          acc[p][2] = fmaf(wj[u], gv[u][p].z, acc[p][2]);
          acc[p][3] = fmaf(wj[u], gv[u][p].w, acc[p][3]);
        }
    }
    for (; j < n; ++j) {
      const float wj = __shfl_sync(0xffffffffu, w, j, kLanes);
      const float* row = gr + (int64_t)(kb + j) * D;
#pragma unroll
      for (int p = 0; p < kVecs; ++p)
        if (live[p]) {
          const float4 gv = __ldg(reinterpret_cast<const float4*>(row + dv[p]));
          acc[p][0] = fmaf(wj, gv.x, acc[p][0]);
          acc[p][1] = fmaf(wj, gv.y, acc[p][1]);
          acc[p][2] = fmaf(wj, gv.z, acc[p][2]);
          acc[p][3] = fmaf(wj, gv.w, acc[p][3]);
        }
    }
  }

  if (!live_row) return;
  float* orow = out + r * D;
#pragma unroll
  for (int p = 0; p < kVecs; ++p)
    if (live[p])
      *reinterpret_cast<float4*>(orow + dv[p]) =
          make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_reduce_scalar_kernel(const float* __restrict__ g, const float* __restrict__ vals,
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
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int d = c0 + lane + 32 * q;
        if (d < D) acc[q] = fmaf(vj, __ldg(row + d), acc[q]);
      }
    }
  }

  float* orow = out + r * D;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int d = c0 + lane + 32 * q;
    if (d < D) orow[d] = acc[q];
  }
}

unsigned blocks_for(int64_t rows) {
  return (unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" int ell_reduce_f32(const void* g, const void* vals, void* out,
                              int64_t R, int K, int D, void* stream) {
  if (R <= 0 || K < 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(kWarpsPerBlock * 32);
  const float* gf = (const float*)g;
  const float* vf = (const float*)vals;
  float* of = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  // 16-byte row loads need D % 4 == 0 and 16-byte aligned base pointers
  const bool vec = D % 4 == 0 && ((uintptr_t)g % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0);
  if (vec && D <= kChunk) {  // two rows per warp
    ell_reduce_vec_kernel<2><<<dim3(blocks_for((R + 1) / 2), 1), block, 0, s>>>(
        gf, vf, of, R, K, D);
  } else if (vec) {  // one row per warp, 256 columns
    ell_reduce_vec_kernel<1><<<dim3(blocks_for(R), (D + 2 * kChunk - 1) / (2 * kChunk)),
                               block, 0, s>>>(gf, vf, of, R, K, D);
  } else {
    ell_reduce_scalar_kernel<<<dim3(blocks_for(R), (D + kChunk - 1) / kChunk), block,
                               0, s>>>(gf, vf, of, R, K, D);
  }
  return (int)cudaGetLastError();
}
