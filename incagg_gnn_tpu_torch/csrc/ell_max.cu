// Kernel B's max form: the hybrid aggregation's row-max over the real ELL
// slots and each row's overflow tail in one launch, with the count of the
// slots that reach the max (the ties), and its backward over the transpose
// hybrid.
//
// Forward (hybrid_max_f32):
//
//   out[r, d]  = deg[r] > 0 ? max over the real slots s of row r of x[col(s), d] : 0
//   ties[r, d] = deg[r] > 0 ? max(1, #{s : x[col(s), d] == out[r, d]}) : 1
//
// Backward (hybrid_max_bwd_f32), over the transpose hybrid (rows = x rows c,
// columns = forward rows r):
//
//   h[r, d]  = deg_fwd[r] > 0 ? g[r, d] / ties[r, d] : 0
//   dx[c, d] = sum over the real slots r of row c of (out[r, d] == x[c, d] ? h[r, d] : 0)
//
// Replaces XLA code of the JAX package, not a Pallas kernel: the masked row
// max incagg_gnn_tpu/ops/ell.py::_ell_max with the overflow's segment_max
// (spmm_hybrid_max, :955), the tie count _max_tie_count (:970) and the
// custom VJP _spmm_max_bi_bw (:1007), which splits a row's cotangent evenly
// among the slots that tie for its max, as JAX autodiff of max does.  Min is
// -max(-x) in the callers.
// cols [R, K] int32, vals [R, K] f32, ovf_ptr [R + 1] int32 over ovf_cols /
// ovf_vals (one row's tail contiguous; the overflow's padding entries lie
// past ovf_ptr[R]), deg [R] f32, x [C, D] f32, out and ties [R, D] f32.
//
// Bound.  Memory, like kernel B's sum: each real slot reads one x row
// (forward) or one row each of h and out (backward) for a compare and a
// select per column.  Design, kernel B's (ell_spmm.cu):
// - Only real slots cost a gather: a group of lanes reads its row's
//   (col, val) pairs with one coalesced load per chunk, ballots val != 0 and
//   walks the set bits; padding costs nothing.
// - One lane group covers a whole row (D <= 128: ceil(D/4) lanes of one
//   float4; 128 < D <= 256: a warp, two float4 a lane; wider D: 256-column
//   chunks across blockIdx.y, each reading the pairs again), with eight
//   16-byte gathers a lane in flight.
// - The tail is walked by the warp that owns the row after its ELL slots:
//   no [O, D] intermediate, no atomics.
// - The running pair (m, n) uses comparisons only, so out is bit for bit an
//   element of x (the backward's equality test relies on it): v > m sets
//   m = v, n = 1; v == m adds 1 to n.  m starts at -FLT_MAX (the JAX
//   sentinel finfo.min), n at 0.  The max and the count do not depend on
//   the order of the slots, so they equal the plain version exactly.
// - The backward reads each real slot's h and out rows (h = g / ties,
//   written by one elementwise pass over the forward rows first, so a slot
//   costs two gathers, not three) and the output row's x once.  It keeps an
//   ELL and a tail accumulator and writes ell_sum + tail_sum, the
//   reference's association.
// A scalar path (one warp per row and 128 columns) takes D not a multiple
// of 4 or an operand off a 16-byte boundary.  Comparisons follow IEEE:
// -0.0 == 0.0; a NaN never wins and never ties.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kLoadsInFlight = 8;  // 16-byte gathers a lane issues before their use
constexpr int kChunk = 128;   // columns per warp on the scalar path

__device__ __forceinline__ void take(float v, float& m, int& n) {
  const bool gt = v > m;
  n = gt ? 1 : n + (v == m ? 1 : 0);
  m = gt ? v : m;
}

__device__ __forceinline__ void take4(const float4& v, float (&m)[4], int (&n)[4]) {
  take(v.x, m[0], n[0]);
  take(v.y, m[1], n[1]);
  take(v.z, m[2], n[2]);
  take(v.w, m[3], n[3]);
}

// One chunk of candidate slots of the forward: lane base + j of a group
// holds slot j's (c, v) and whether it exists.
template <int kVecs>
__device__ __forceinline__ void max_chunk(int32_t c, float v, bool ok, int base,
                                          unsigned gmask, const float* __restrict__ x,
                                          int D, const int (&dv)[kVecs],
                                          const bool (&dl)[kVecs], float (&m)[kVecs][4],
                                          int (&n)[kVecs][4]) {
  constexpr int kSlots = kLoadsInFlight / kVecs;
  unsigned bits = (__ballot_sync(kFull, ok && v != 0.f) & gmask) >> base;
  const int steps = __reduce_max_sync(kFull, __popc(bits));
  for (int i = 0; i < steps; i += kSlots) {
    bool on[kSlots];
    float4 xv[kSlots][kVecs];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      on[u] = bits != 0;
      const int src = base + (on[u] ? __ffs(bits) - 1 : 0);
      bits &= bits - 1;
      const int32_t cj = __shfl_sync(kFull, c, src);
      const float* row = x + (int64_t)cj * D;
#pragma unroll
      for (int p = 0; p < kVecs; ++p)
        xv[u][p] = on[u] && dl[p] ? __ldg(reinterpret_cast<const float4*>(row + dv[p]))
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kSlots; ++u)
      if (on[u]) {
#pragma unroll
        for (int p = 0; p < kVecs; ++p) take4(xv[u][p], m[p], n[p]);
      }
  }
}

// kVecs float4 per lane; L lanes per row (the group), G rows per warp.
// Lane l of a group covers columns c0 + (p * L + l) * 4 .. + 3.
template <int kVecs>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
hybrid_max_vec_kernel(const int32_t* __restrict__ cols, const float* __restrict__ vals,
                      const int32_t* __restrict__ ovf_ptr,
                      const int32_t* __restrict__ ovf_cols,
                      const float* __restrict__ ovf_vals, const float* __restrict__ deg,
                      const float* __restrict__ x, float* __restrict__ out,
                      float* __restrict__ ties, int64_t R, int K, int D, int L, int G) {
  const int lane = threadIdx.x & 31;
  const int64_t r0 = ((int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * G;
  if (r0 >= R) return;  // uniform across the warp
  const int grp = lane / L;
  const int l = lane - grp * L;
  const int base = grp * L;
  const unsigned gmask = (L == 32 ? kFull : (1u << L) - 1u) << base;
  const int64_t r = r0 + grp;
  const bool live = grp < G && r < R;  // lanes past G * L serve no row
  const int c0 = blockIdx.y * L * 4 * kVecs;
  int dv[kVecs];
  bool dl[kVecs];
#pragma unroll
  for (int p = 0; p < kVecs; ++p) {
    dv[p] = c0 + (p * L + l) * 4;
    dl[p] = live && dv[p] < D;
  }
  float m[kVecs][4];
  int n[kVecs][4];
#pragma unroll
  for (int p = 0; p < kVecs; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      m[p][q] = -FLT_MAX;
      n[p][q] = 0;
    }

  const int64_t rr = live ? r : 0;
  const int32_t* cr = cols + rr * K;
  const float* vr = vals + rr * K;
  for (int kb = 0; kb < K; kb += L) {
    const bool ok = live && kb + l < K;
    max_chunk<kVecs>(ok ? cr[kb + l] : 0, ok ? vr[kb + l] : 0.f, ok, base, gmask, x, D,
                     dv, dl, m, n);
  }
  const int p0 = live ? ovf_ptr[rr] : 0;
  const int len = live ? ovf_ptr[rr + 1] - p0 : 0;
  const int longest = __reduce_max_sync(kFull, len);
  for (int kb = 0; kb < longest; kb += L) {
    const bool ok = kb + l < len;
    max_chunk<kVecs>(ok ? ovf_cols[p0 + kb + l] : 0, ok ? ovf_vals[p0 + kb + l] : 0.f, ok,
                     base, gmask, x, D, dv, dl, m, n);
  }

  const bool has = live && deg[rr] > 0.f;
  float* orow = out + rr * D;
  float* trow = ties + rr * D;
#pragma unroll
  for (int p = 0; p < kVecs; ++p)
    if (dl[p]) {
      *reinterpret_cast<float4*>(orow + dv[p]) =
          has ? make_float4(m[p][0], m[p][1], m[p][2], m[p][3])
              : make_float4(0.f, 0.f, 0.f, 0.f);
      if (ties != nullptr)
        *reinterpret_cast<float4*>(trow + dv[p]) =
            has ? make_float4((float)max(n[p][0], 1), (float)max(n[p][1], 1),
                              (float)max(n[p][2], 1), (float)max(n[p][3], 1))
                : make_float4(1.f, 1.f, 1.f, 1.f);
    }
}

// One chunk of up to 32 slots on the scalar path: the set bits one by one.
__device__ __forceinline__ void max_chunk_scalar(int32_t c, float v, bool ok, int lane,
                                                 int c0, const float* __restrict__ x,
                                                 int D, float (&m)[4], int (&n)[4]) {
  unsigned bits = __ballot_sync(kFull, ok && v != 0.f);
  while (bits) {  // uniform: every lane holds the same bits
    const int j = __ffs(bits) - 1;
    bits &= bits - 1;
    const int32_t cj = __shfl_sync(kFull, c, j);
    const float* row = x + (int64_t)cj * D;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int d = c0 + lane + 32 * q;
      if (d < D) take(__ldg(row + d), m[q], n[q]);
    }
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
hybrid_max_scalar_kernel(const int32_t* __restrict__ cols, const float* __restrict__ vals,
                         const int32_t* __restrict__ ovf_ptr,
                         const int32_t* __restrict__ ovf_cols,
                         const float* __restrict__ ovf_vals,
                         const float* __restrict__ deg, const float* __restrict__ x,
                         float* __restrict__ out, float* __restrict__ ties, int64_t R,
                         int K, int D) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;  // uniform across the warp
  const int c0 = blockIdx.y * kChunk;
  const int32_t* cr = cols + r * K;
  const float* vr = vals + r * K;
  float m[4] = {-FLT_MAX, -FLT_MAX, -FLT_MAX, -FLT_MAX};
  int n[4] = {0, 0, 0, 0};
  for (int kb = 0; kb < K; kb += 32) {
    const bool ok = kb + lane < K;
    max_chunk_scalar(ok ? cr[kb + lane] : 0, ok ? vr[kb + lane] : 0.f, ok, lane, c0, x,
                     D, m, n);
  }
  const int p0 = ovf_ptr[r];
  const int len = ovf_ptr[r + 1] - p0;
  for (int kb = 0; kb < len; kb += 32) {
    const bool ok = kb + lane < len;
    max_chunk_scalar(ok ? ovf_cols[p0 + kb + lane] : 0,
                     ok ? ovf_vals[p0 + kb + lane] : 0.f, ok, lane, c0, x, D, m, n);
  }
  const bool has = deg[r] > 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int d = c0 + lane + 32 * q;
    if (d < D) {
      out[r * D + d] = has ? m[q] : 0.f;
      if (ties != nullptr) ties[r * D + d] = has ? (float)max(n[q], 1) : 1.f;
    }
  }
}

// h = (deg_fwd > 0 ? g : 0) / ties over the forward rows, one warp a row.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
max_bwd_scale_kernel(const float* __restrict__ g, const float* __restrict__ ties,
                     const float* __restrict__ deg, float* __restrict__ h, int64_t R, int D) {
  const int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;
  const int lane = threadIdx.x & 31;
  const bool has = deg[r] > 0.f;
  const int64_t o = r * D;
  for (int d = lane; d < D; d += 32) h[o + d] = (has ? g[o + d] : 0.f) / ties[o + d];
}

__device__ __forceinline__ void pick4(const float4& o, const float4& xc, const float4& hv,
                                      float (&acc)[4]) {
  acc[0] += o.x == xc.x ? hv.x : 0.f;
  acc[1] += o.y == xc.y ? hv.y : 0.f;
  acc[2] += o.z == xc.z ? hv.z : 0.f;
  acc[3] += o.w == xc.w ? hv.w : 0.f;
}

// One chunk of candidate slots of the backward: each taken slot gathers
// two rows (h and out), so half as many slots go together as in the forward.
template <int kVecs>
__device__ __forceinline__ void bwd_chunk(int32_t c, float v, bool ok, int base,
                                          unsigned gmask, const float* __restrict__ h,
                                          const float* __restrict__ out, int D,
                                          const int (&dv)[kVecs], const bool (&dl)[kVecs],
                                          const float4 (&xc)[kVecs],
                                          float (&acc)[kVecs][4]) {
  constexpr int kSlots = kLoadsInFlight / (2 * kVecs);
  unsigned bits = (__ballot_sync(kFull, ok && v != 0.f) & gmask) >> base;
  const int steps = __reduce_max_sync(kFull, __popc(bits));
  for (int i = 0; i < steps; i += kSlots) {
    bool on[kSlots];
    float4 hv[kSlots][kVecs], ov[kSlots][kVecs];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      on[u] = bits != 0;
      const int src = base + (on[u] ? __ffs(bits) - 1 : 0);
      bits &= bits - 1;
      const int64_t off = (int64_t)__shfl_sync(kFull, c, src) * D;
#pragma unroll
      for (int p = 0; p < kVecs; ++p) {
        const bool go = on[u] && dl[p];
        hv[u][p] = go ? __ldg(reinterpret_cast<const float4*>(h + off + dv[p]))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
        ov[u][p] = go ? __ldg(reinterpret_cast<const float4*>(out + off + dv[p]))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < kSlots; ++u)
      if (on[u]) {
#pragma unroll
        for (int p = 0; p < kVecs; ++p) pick4(ov[u][p], xc[p], hv[u][p], acc[p]);
      }
  }
}

template <int kVecs>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
hybrid_max_bwd_vec_kernel(const int32_t* __restrict__ cols, const float* __restrict__ vals,
                          const int32_t* __restrict__ ovf_ptr,
                          const int32_t* __restrict__ ovf_cols,
                          const float* __restrict__ ovf_vals, const float* __restrict__ h,
                          const float* __restrict__ out, const float* __restrict__ x,
                          float* __restrict__ dx, int64_t C, int K, int D, int L, int G) {
  const int lane = threadIdx.x & 31;
  const int64_t r0 = ((int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * G;
  if (r0 >= C) return;  // uniform across the warp
  const int grp = lane / L;
  const int l = lane - grp * L;
  const int base = grp * L;
  const unsigned gmask = (L == 32 ? kFull : (1u << L) - 1u) << base;
  const int64_t r = r0 + grp;
  const bool live = grp < G && r < C;
  const int c0 = blockIdx.y * L * 4 * kVecs;
  const int64_t rr = live ? r : 0;
  int dv[kVecs];
  bool dl[kVecs];
  float4 xc[kVecs];
#pragma unroll
  for (int p = 0; p < kVecs; ++p) {
    dv[p] = c0 + (p * L + l) * 4;
    dl[p] = live && dv[p] < D;
    xc[p] = dl[p] ? __ldg(reinterpret_cast<const float4*>(x + rr * D + dv[p]))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float acc[kVecs][4] = {};
  float tail[kVecs][4] = {};

  const int32_t* cr = cols + rr * K;
  const float* vr = vals + rr * K;
  for (int kb = 0; kb < K; kb += L) {
    const bool ok = live && kb + l < K;
    bwd_chunk<kVecs>(ok ? cr[kb + l] : 0, ok ? vr[kb + l] : 0.f, ok, base, gmask, h, out,
                     D, dv, dl, xc, acc);
  }
  const int p0 = live ? ovf_ptr[rr] : 0;
  const int len = live ? ovf_ptr[rr + 1] - p0 : 0;
  const int longest = __reduce_max_sync(kFull, len);
  for (int kb = 0; kb < longest; kb += L) {
    const bool ok = kb + l < len;
    bwd_chunk<kVecs>(ok ? ovf_cols[p0 + kb + l] : 0, ok ? ovf_vals[p0 + kb + l] : 0.f, ok,
                     base, gmask, h, out, D, dv, dl, xc, tail);
  }

  float* orow = dx + rr * D;
#pragma unroll
  for (int p = 0; p < kVecs; ++p)
    if (dl[p])
      *reinterpret_cast<float4*>(orow + dv[p]) =
          make_float4(acc[p][0] + tail[p][0], acc[p][1] + tail[p][1],
                      acc[p][2] + tail[p][2], acc[p][3] + tail[p][3]);
}

__device__ __forceinline__ void bwd_chunk_scalar(int32_t c, float v, bool ok, int lane,
                                                 int c0, const float* __restrict__ h,
                                                 const float* __restrict__ out, int D,
                                                 const float (&xc)[4], float (&acc)[4]) {
  unsigned bits = __ballot_sync(kFull, ok && v != 0.f);
  while (bits) {  // uniform: every lane holds the same bits
    const int j = __ffs(bits) - 1;
    bits &= bits - 1;
    const int64_t off = (int64_t)__shfl_sync(kFull, c, j) * D;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int d = c0 + lane + 32 * q;
      if (d < D) acc[q] += __ldg(out + off + d) == xc[q] ? __ldg(h + off + d) : 0.f;
    }
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
hybrid_max_bwd_scalar_kernel(const int32_t* __restrict__ cols,
                             const float* __restrict__ vals,
                             const int32_t* __restrict__ ovf_ptr,
                             const int32_t* __restrict__ ovf_cols,
                             const float* __restrict__ ovf_vals,
                             const float* __restrict__ h, const float* __restrict__ out,
                             const float* __restrict__ x, float* __restrict__ dx,
                             int64_t C, int K, int D) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= C) return;  // uniform across the warp
  const int c0 = blockIdx.y * kChunk;
  float xc[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int d = c0 + lane + 32 * q;
    xc[q] = d < D ? __ldg(x + r * D + d) : 0.f;
  }
  const int32_t* cr = cols + r * K;
  const float* vr = vals + r * K;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float tail[4] = {0.f, 0.f, 0.f, 0.f};
  for (int kb = 0; kb < K; kb += 32) {
    const bool ok = kb + lane < K;
    bwd_chunk_scalar(ok ? cr[kb + lane] : 0, ok ? vr[kb + lane] : 0.f, ok, lane, c0, h,
                     out, D, xc, acc);
  }
  const int p0 = ovf_ptr[r];
  const int len = ovf_ptr[r + 1] - p0;
  for (int kb = 0; kb < len; kb += 32) {
    const bool ok = kb + lane < len;
    bwd_chunk_scalar(ok ? ovf_cols[p0 + kb + lane] : 0,
                     ok ? ovf_vals[p0 + kb + lane] : 0.f, ok, lane, c0, h, out, D, xc,
                     tail);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int d = c0 + lane + 32 * q;
    if (d < D) dx[r * D + d] = acc[q] + tail[q];
  }
}

unsigned blocks_for(int64_t warps) {
  return (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

bool aligned(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

// ties == nullptr: the forward alone (eval and refresh).
extern "C" int hybrid_max_f32(const void* cols, const void* vals, const void* ovf_ptr,
                              const void* ovf_cols, const void* ovf_vals, const void* deg,
                              const void* x, void* out, void* ties, int64_t R, int K,
                              int D, void* stream) {
  if (R <= 0 || K < 0 || D <= 0 || ovf_ptr == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* c = (const int32_t*)cols;
  const float* v = (const float*)vals;
  const int32_t* op = (const int32_t*)ovf_ptr;
  const int32_t* oc = (const int32_t*)ovf_cols;
  const float* ov = (const float*)ovf_vals;
  const float* dg = (const float*)deg;
  const float* xf = (const float*)x;
  float* of = (float*)out;
  float* tf = (float*)ties;
  const bool vec = D % 4 == 0 && aligned(x) && aligned(out) && (ties == nullptr || aligned(ties));
  if (!vec) {
    hybrid_max_scalar_kernel<<<dim3(blocks_for(R), (D + kChunk - 1) / kChunk), block, 0, s>>>(
        c, v, op, oc, ov, dg, xf, of, tf, R, K, D);
  } else if (D <= 128) {  // ceil(D/4) lanes per row, several rows per warp
    const int L = D / 4;
    const int G = 32 / L;
    hybrid_max_vec_kernel<1><<<dim3(blocks_for((R + G - 1) / G), 1), block, 0, s>>>(
        c, v, op, oc, ov, dg, xf, of, tf, R, K, D, L, G);
  } else if (D <= 256) {  // one warp per row, two float4 per lane
    hybrid_max_vec_kernel<2><<<dim3(blocks_for(R), 1), block, 0, s>>>(
        c, v, op, oc, ov, dg, xf, of, tf, R, K, D, (D / 4 + 1) / 2, 1);
  } else {  // 256-column chunks
    hybrid_max_vec_kernel<2><<<dim3(blocks_for(R), (D + 255) / 256), block, 0, s>>>(
        c, v, op, oc, ov, dg, xf, of, tf, R, K, D, 32, 1);
  }
  return (int)cudaGetLastError();
}

// The tables are the transpose's (C rows, K slots naming forward rows);
// g, ties, out and h are [R_fwd, D], deg_fwd [R_fwd], x and dx [C, D]; h is
// scratch that the caller allocates.
extern "C" int hybrid_max_bwd_f32(const void* cols, const void* vals, const void* ovf_ptr,
                                  const void* ovf_cols, const void* ovf_vals, const void* g,
                                  const void* ties, const void* out, const void* deg_fwd,
                                  const void* x, void* h, void* dx, int64_t C, int K, int D,
                                  int64_t R_fwd, void* stream) {
  if (C <= 0 || K < 0 || D <= 0 || R_fwd <= 0 || ovf_ptr == nullptr)
    return (int)cudaErrorInvalidValue;
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = (cudaStream_t)stream;
  max_bwd_scale_kernel<<<blocks_for(R_fwd), block, 0, s>>>(
      (const float*)g, (const float*)ties, (const float*)deg_fwd, (float*)h, R_fwd, D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int32_t* c = (const int32_t*)cols;
  const float* v = (const float*)vals;
  const int32_t* op = (const int32_t*)ovf_ptr;
  const int32_t* oc = (const int32_t*)ovf_cols;
  const float* ov = (const float*)ovf_vals;
  const float* hf = (const float*)h;
  const float* of = (const float*)out;
  const float* xf = (const float*)x;
  float* df = (float*)dx;
  const bool vec = D % 4 == 0 && aligned(h) && aligned(out) && aligned(x) && aligned(dx);
  if (!vec) {
    hybrid_max_bwd_scalar_kernel<<<dim3(blocks_for(C), (D + kChunk - 1) / kChunk), block, 0,
                                   s>>>(c, v, op, oc, ov, hf, of, xf, df, C, K, D);
  } else if (D <= 128) {
    const int L = D / 4;
    const int G = 32 / L;
    hybrid_max_bwd_vec_kernel<1><<<dim3(blocks_for((C + G - 1) / G), 1), block, 0, s>>>(
        c, v, op, oc, ov, hf, of, xf, df, C, K, D, L, G);
  } else if (D <= 256) {
    hybrid_max_bwd_vec_kernel<2><<<dim3(blocks_for(C), 1), block, 0, s>>>(
        c, v, op, oc, ov, hf, of, xf, df, C, K, D, (D / 4 + 1) / 2, 1);
  } else {
    hybrid_max_bwd_vec_kernel<2><<<dim3(blocks_for(C), (D + 255) / 256), block, 0, s>>>(
        c, v, op, oc, ov, hf, of, xf, df, C, K, D, 32, 1);
  }
  return (int)cudaGetLastError();
}
