// Kernel A: dense-tile aggregation for the block tier and the hybrid
// overflow-incidence tiles.
//
// Replaces the Pallas kernel incagg_gnn_tpu/ops/block.py::_dense_call.  For
// every step i of the tile list, out[rb rows of row-block brow_step[i]] +=
// sum_j A[i*lanes + j] @ x[128-row block bcols[j, i]], accumulated in f32.
// A tile is [rb, 128] (rb = 128, 256 or 512), f32 or bf16; x [C, D] has the
// tile dtype; out is [nrb*rb, D] f32.
//
// Design.  The TPU grid runs in order and carries a row-block's sum across
// consecutive steps in VMEM; blocks on Hopper run in no order, so here one
// CTA owns a [128-row, 64-column] slice of one output row-block.  It finds
// its row-block's contiguous run of steps by binary search over the sorted
// brow_step, walks the run's tiles, stages a [128, 32] slice of the A tile
// and the matching [32, 64] slice of the x block in shared memory, and writes
// its output slice once (zeros for a row-block without steps).  No atomics,
// no cross-CTA sums.
//
// Bound.  A dense product costs rb*128*D multiply-adds per tile whatever
// its edge count, and the tiles of a GCN batch are sparse (tens of edges in
// a [512, 128] tile), so the design skips the zeros it can see cheaply:
// a [128, 32] chunk of A that is all zero skips its x staging and its
// products (__syncthreads_or), and a warp whose 16 rows are zero over four
// k-steps skips those 128 FMAs per thread (__any_sync).  Skipped products
// are exact zeros, so the sum is the dense sum (for finite x).  What is
// left is bound by staging A: each tile is read in full, once from device
// memory and once per column slice from L2.  The column slices of one row
// slice are adjacent in launch order, so they run together and share each
// A tile through L2.  f32 tiles use plain f32 FMA: the reference multiplies
// f32 tiles at full f32, so no TF32 and no tensor cores; bf16 tiles are
// converted to f32 with the intrinsics and accumulate in f32 (bf16 x bf16
// products are exact in f32).  Each thread holds an 8x4 accumulator and reads
// its A rows four k-steps at a time as float4.  wgmma and TMA are the later
// steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileK = 128;   // tile width = rows of an x block
constexpr int kBM = 128;      // output rows per CTA
constexpr int kBN = 64;       // output columns per CTA
constexpr int kBK = 32;       // inner chunk staged per pass
constexpr int kAPad = 4;      // keeps each As row 16-byte aligned
constexpr int kThreads = 256; // 16 x 16 threads, 8 rows x 4 columns each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// four consecutive tile values as f32 (16-byte f32 or 8-byte bf16 load)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ uint32_t bits_of(const float4& v) {
  return __float_as_uint(v.x) | __float_as_uint(v.y) | __float_as_uint(v.z) |
         __float_as_uint(v.w);
}

__device__ __forceinline__ float lane_of(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// first index in sorted a[0, n) whose value is >= key
__device__ __forceinline__ int64_t lower_bound(const int32_t* a, int64_t n,
                                               int64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
block_spmm_kernel(const T* __restrict__ a, const int32_t* __restrict__ brow_step,
                  const int32_t* __restrict__ bcols, const T* __restrict__ x,
                  float* __restrict__ out, int64_t S, int lanes, int rb, int D) {
  __shared__ __align__(16) float As[kBM][kBK + kAPad];
  __shared__ __align__(16) float Xs[kBK][kBN];

  // column slice fastest: the slices of one row slice share its A tiles
  const int n_dslices = (D + kBN - 1) / kBN;
  const int sub_per_rb = rb / kBM;
  const int64_t row_slice = blockIdx.x / n_dslices;
  const int d0 = (int)(blockIdx.x % n_dslices) * kBN;
  const int64_t rbk = row_slice / sub_per_rb;           // output row-block
  const int r0 = (int)(row_slice % sub_per_rb) * kBM;   // rows within the tile
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  const int64_t s_lo = lower_bound(brow_step, S, rbk);
  const int64_t s_hi = lower_bound(brow_step, S, rbk + 1);

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int64_t s = s_lo; s < s_hi; ++s) {
    for (int l = 0; l < lanes; ++l) {
      const int64_t t = s * lanes + l;
      const int64_t cb = bcols[(int64_t)l * S + s];
      const T* at = a + (t * rb + r0) * kTileK;   // [kBM rows][128]
      const T* xt = x + cb * kTileK * (int64_t)D;  // [128 rows][D]
      for (int k0 = 0; k0 < kTileK; k0 += kBK) {
        uint32_t nz = 0;
#pragma unroll
        for (int e = tid; e < kBM * kBK / 4; e += kThreads) {
          const int r = e / (kBK / 4), c = (e % (kBK / 4)) * 4;
          const float4 v = load4(at + (int64_t)r * kTileK + k0 + c);
          nz |= bits_of(v);
          *reinterpret_cast<float4*>(&As[r][c]) = v;
        }
        if (!__syncthreads_or(nz)) continue;  // chunk of A all zero
#pragma unroll 4
        for (int e = tid; e < kBK * kBN; e += kThreads) {
          const int r = e / kBN, c = e % kBN;
          const int d = d0 + c;
          Xs[r][c] = d < D ? to_f32(xt[(int64_t)(k0 + r) * D + d]) : 0.f;
        }
        __syncthreads();
#pragma unroll 2
        for (int kk = 0; kk < kBK; kk += 4) {
          float4 av[8];
          uint32_t wnz = 0;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            av[i] = *reinterpret_cast<const float4*>(&As[ty + 16 * i][kk]);
            wnz |= bits_of(av[i]);
          }
          if (!__any_sync(0xffffffffu, wnz != 0)) continue;  // warp's rows zero
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 xv = *reinterpret_cast<const float4*>(&Xs[kk + q][tx * 4]);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float av_q = lane_of(av[i], q);
              acc[i][0] = fmaf(av_q, xv.x, acc[i][0]);
              acc[i][1] = fmaf(av_q, xv.y, acc[i][1]);
              acc[i][2] = fmaf(av_q, xv.z, acc[i][2]);
              acc[i][3] = fmaf(av_q, xv.w, acc[i][3]);
            }
          }
        }
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t row = rbk * rb + r0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + tx * 4 + j;
      if (d < D) out[row * D + d] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* a, const void* brow_step, const void* bcols,
           const void* x, void* out, int64_t S, int lanes, int rb, int D,
           int64_t nrb, void* stream) {
  if (rb % kBM != 0 || D <= 0 || nrb <= 0) return (int)cudaErrorInvalidValue;
  const int64_t ctas = nrb * (rb / kBM) * ((D + kBN - 1) / kBN);
  if (ctas > INT32_MAX) return (int)cudaErrorInvalidValue;
  block_spmm_kernel<T><<<(unsigned)ctas, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)a, (const int32_t*)brow_step, (const int32_t*)bcols,
      (const T*)x, (float*)out, S, lanes, rb, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int block_spmm_f32(const void* a, const void* brow_step,
                              const void* bcols, const void* x, void* out,
                              int64_t S, int lanes, int rb, int D, int64_t nrb,
                              void* stream) {
  return launch<float>(a, brow_step, bcols, x, out, S, lanes, rb, D, nrb, stream);
}

extern "C" int block_spmm_bf16(const void* a, const void* brow_step,
                               const void* bcols, const void* x, void* out,
                               int64_t S, int lanes, int rb, int D, int64_t nrb,
                               void* stream) {
  return launch<__nv_bfloat16>(a, brow_step, bcols, x, out, S, lanes, rb, D,
                               nrb, stream);
}
