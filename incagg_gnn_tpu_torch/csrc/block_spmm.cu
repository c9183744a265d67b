// Kernel A: the dense tier's aggregation (and the hybrid overflow
// incidence), read from the tiles' nonzeros.
//
// Replaces the Pallas kernel incagg_gnn_tpu/ops/block.py::_dense_call, which
// multiplies every [rb, 128] tile with the 128-row block of x its column
// block names and sums the products by row-block.  Here the tiles arrive as
// their nonzeros in tile-CSR form (ops/block.py::BlockDense): for each dense
// output row r, entries rowptr[r]..rowptr[r+1] give the x row cols[e] =
// bcol * 128 + c of each nonzero cell and its value vals[e], in the order the
// tile product sums them.  out[r] = sum_e vals[e] * x[cols[e]], f32 or bf16
// values and x (the same type), f32 out; rows with no entry are written 0.
//
// Why the cells are gone.  The tiles of these graphs are far from dense: an
// sbm-arxiv [512, 128] tile holds about 170 nonzeros in 65,536 cells.
// Reading the cells cost more than the whole product over the nonzeros costs
// in a library, so no kernel that reads them can keep up; the nonzeros carry
// the same function.  No tile is dense enough for tensor cores (wgmma, TMA)
// to pay, so they are not used.
//
// Bound.  Memory: the entries (8 bytes each in f32, 6 in bf16, plus rowptr),
// the x rows they reference (D values each, gathered), and the output
// written once, against 2*D flops per entry.  Design: kernel B's layout
// (ell_spmm.cu) over variable-length rows.  One warp per output row and
// chunk of columns (128, or 256 when D > 128, so that a warp gathers a whole
// 1 KB x row of a D = 256 f32 table); the warp reads 32 entries' (col, val)
// pairs with one coalesced load and broadcasts them with shuffles, then each
// lane gathers 4 contiguous values (16 bytes in f32, 8 in bf16) of each x
// row per 128 columns, four entries' loads issued before their FMAs so that
// several gathers are in flight.  Sums are f32 registers in the entries'
// order; no atomics, no TF32 (f32 values use plain f32 FMA; bf16 x bf16
// products are exact in f32).  A scalar path (128 columns per warp) takes D
// not a multiple of 4 or misaligned x.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kChunk = 128;  // columns per lane group: 32 lanes x 4
constexpr int kInFlight = 4;  // entries whose x loads are issued together

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// four consecutive values of an x row as f32 (16-byte f32 or 8-byte bf16 load)
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void fma4(float (&acc)[4], float v, const float4& xv) {
  acc[0] = fmaf(v, xv.x, acc[0]);
  acc[1] = fmaf(v, xv.y, acc[1]);
  acc[2] = fmaf(v, xv.z, acc[2]);
  acc[3] = fmaf(v, xv.w, acc[3]);
}

// kVecs > 0: vector path, a warp covers kVecs * 128 columns, each lane
// kVecs groups of 4; kVecs == 0: scalar path, 128 columns, 4 per lane
template <typename T, int kVecs>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
block_spmm_kernel(const int32_t* __restrict__ rowptr,
                  const int32_t* __restrict__ cols, const T* __restrict__ vals,
                  const T* __restrict__ x, float* __restrict__ out, int64_t R,
                  int D) {
  constexpr int kV = kVecs > 0 ? kVecs : 1;
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;  // uniform across the warp
  const int c0 = blockIdx.y * kChunk * kV;
  const int e0 = rowptr[r], e1 = rowptr[r + 1];
  int d[kV];  // vector path: this lane's groups of 4 columns
  bool live[kV];
#pragma unroll
  for (int p = 0; p < kV; ++p) {
    d[p] = c0 + p * kChunk + lane * 4;
    live[p] = d[p] < D;
  }
  float acc[kV][4] = {};

  for (int eb = e0; eb < e1; eb += 32) {
    const int n = min(32, e1 - eb);
    const int32_t c = lane < n ? cols[eb + lane] : 0;
    const float v = lane < n ? to_f32(vals[eb + lane]) : 0.f;
    int j = 0;
    if (kVecs > 0) {
      for (; j + kInFlight <= n; j += kInFlight) {
        float vj[kInFlight];
        float4 xv[kInFlight][kV];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int64_t cj = __shfl_sync(0xffffffffu, c, j + u);
          vj[u] = __shfl_sync(0xffffffffu, v, j + u);
#pragma unroll
          for (int p = 0; p < kV; ++p)
            xv[u][p] = live[p] ? load4(x + cj * D + d[p])
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u)
#pragma unroll
          for (int p = 0; p < kV; ++p) fma4(acc[p], vj[u], xv[u][p]);
      }
    }
    for (; j < n; ++j) {
      const int64_t cj = __shfl_sync(0xffffffffu, c, j);
      const float vj = __shfl_sync(0xffffffffu, v, j);
      const T* xr = x + cj * D;
      if (kVecs > 0) {
#pragma unroll
        for (int p = 0; p < kV; ++p)
          if (live[p]) fma4(acc[p], vj, load4(xr + d[p]));
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int dq = c0 + lane + 32 * q;
          if (dq < D) acc[0][q] = fmaf(vj, to_f32(xr[dq]), acc[0][q]);
        }
      }
    }
  }

  float* orow = out + r * D;
  if (kVecs > 0) {
#pragma unroll
    for (int p = 0; p < kV; ++p)
      if (live[p])
        *reinterpret_cast<float4*>(orow + d[p]) =
            make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int dq = c0 + lane + 32 * q;
      if (dq < D) orow[dq] = acc[0][q];
    }
  }
}

template <typename T>
int launch(const void* rowptr, const void* cols, const void* vals,
           const void* x, void* out, int64_t R, int D, void* stream) {
  if (R <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  const dim3 block(kWarpsPerBlock * 32);
  const int32_t* rp = (const int32_t*)rowptr;
  const int32_t* cl = (const int32_t*)cols;
  cudaStream_t s = (cudaStream_t)stream;
  // 4-value row loads need D % 4 == 0 and aligned x and out
  const bool vec = D % 4 == 0 && ((uintptr_t)x % (4 * sizeof(T)) == 0) &&
                   ((uintptr_t)out % 16 == 0);
  if (vec && D > kChunk) {  // 256 columns per warp
    const dim3 grid((unsigned)blocks, (unsigned)((D + 2 * kChunk - 1) / (2 * kChunk)));
    block_spmm_kernel<T, 2><<<grid, block, 0, s>>>(rp, cl, (const T*)vals,
                                                   (const T*)x, (float*)out, R, D);
  } else {
    const dim3 grid((unsigned)blocks, (unsigned)((D + kChunk - 1) / kChunk));
    if (vec)
      block_spmm_kernel<T, 1><<<grid, block, 0, s>>>(rp, cl, (const T*)vals,
                                                     (const T*)x, (float*)out, R, D);
    else
      block_spmm_kernel<T, 0><<<grid, block, 0, s>>>(rp, cl, (const T*)vals,
                                                     (const T*)x, (float*)out, R, D);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int block_spmm_f32(const void* rowptr, const void* cols,
                              const void* vals, const void* x, void* out,
                              int64_t R, int D, void* stream) {
  return launch<float>(rowptr, cols, vals, x, out, R, D, stream);
}

extern "C" int block_spmm_bf16(const void* rowptr, const void* cols,
                               const void* vals, const void* x, void* out,
                               int64_t R, int D, void* stream) {
  return launch<__nv_bfloat16>(rowptr, cols, vals, x, out, R, D, stream);
}
