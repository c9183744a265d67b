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
// Bound.  The gathers and the instructions around them: each real slot
// reads one x row (forward) or one row each of h and out (backward) for a
// compare and a select per column, and the graph offers little reuse
// within a tile of rows, so a launch gathers ~7x the distinct rows' bytes.
// On PNA's arxiv batch at D768 (1.24M real slots) the forward gathers 3.8
// GB in 0.73 ms (5.2 TB/s).  With the same table folded onto an x of 4,096
// rows (12.6 MB, in L2) it takes 0.59 ms, onto 8 rows (in L1) 0.54 ms: the
// misses past L2 take ~19% of its time and L2 against L1 ~6%; the other
// ~75% is the per-slot ballot, shuffle, compare and select, which remain
// with x in L1 (kernel B's sum, with less work a slot, goes from 0.61 to
// 0.48 and 0.30 ms).  The backward: 1.79 / 1.46 / 1.18 ms (NVIDIA H100 80GB HBM3,
// 700.00 W; profile_agg.py --part max and --part ceiling).  Column chunks
// sized to keep a chunk's rows in L2 (32 to 128 columns) were slower at
// every width, in separate launches and in one launch with the chunk as
// blockIdx.y: a narrower lane group spends the same ballot, shuffle and
// loop per slot on fewer bytes.  Design, kernel B's (ell_spmm.cu):
// - Only real slots cost a gather: a group of lanes reads its row's
//   (col, val) pairs with one coalesced load per chunk, ballots val != 0 and
//   walks the set bits; padding costs nothing.
// - Forward: one lane group covers a whole row (D <= 128: ceil(D/4) lanes
//   of one float4; 128 < D <= 256: a warp, two float4 a lane; wider D:
//   256-column chunks across blockIdx.y, each reading the pairs again), with
//   eight 16-byte gathers a lane in flight.
// - The tail is walked by the lane group that owns the row after its ELL
//   slots: no [O, D] intermediate, no atomics.
// - The running pair (m, n) uses comparisons only, so out is bit for bit an
//   element of x (the backward's equality test relies on it): v > m sets
//   m = v, n = 1; v == m adds 1 to n.  m starts at -FLT_MAX (the JAX
//   sentinel finfo.min), n at 0.  The max and the count do not depend on
//   the order of the slots, so they equal the plain version exactly.
// - Backward: h = g / ties is written first, so a slot costs two gathers
//   (h and out), not three; a lane reads both rows of four slots at once.
//   Each (c, d) has one owner that sums its ELL slots in order and then its
//   tail, into two accumulators written as ell + tail (the reference's
//   association).  Past 128 columns it walks 128-column chunks, one launch
//   each, and the h pass of chunk j + 1 runs in the launch that gathers
//   chunk j (its blocks first).  The h pass alone was 17.5% of the
//   backward (323 of 1,845 us at D768); so placed, the backward takes
//   2.9-4.6% less time at D768 than with the whole h pass first (four
//   calls, each timing both).
//   Dividing g by ties in the gather instead, where a slot reaches the max,
//   or reading h only there, waits on the out row before the second load
//   and ran 1.2-1.8x slower.
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
// The vector paths' column chunks: the forward's past 256 columns (a warp,
// two float4 a lane), the backward's past 128 (a warp, one float4 a lane).
constexpr int kFwdChunk = 32 * 4 * 2;
constexpr int kBwdChunk = 32 * 4;

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

// The scalar path's h = (deg_fwd > 0 ? g : 0) / ties over the forward
// rows, one warp a row.
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
// two rows (h and out), so half as many slots go together as in the
// forward; a lane covers the four columns d .. d + 3 (live: dl).
__device__ __forceinline__ void bwd_chunk(int32_t c, float v, bool ok, int base,
                                          unsigned gmask, const float* __restrict__ h,
                                          const float* __restrict__ out, int D, int d,
                                          bool dl, const float4& xc, float (&acc)[4]) {
  constexpr int kSlots = kLoadsInFlight / 2;
  unsigned bits = (__ballot_sync(kFull, ok && v != 0.f) & gmask) >> base;
  const int steps = __reduce_max_sync(kFull, __popc(bits));
  for (int i = 0; i < steps; i += kSlots) {
    bool on[kSlots];
    float4 hv[kSlots], ov[kSlots];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      on[u] = bits != 0;
      const int src = base + (on[u] ? __ffs(bits) - 1 : 0);
      bits &= bits - 1;
      const int64_t off = (int64_t)__shfl_sync(kFull, c, src) * D + d;
      const bool go = on[u] && dl;
      hv[u] = go ? __ldg(reinterpret_cast<const float4*>(h + off))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
      ov[u] = go ? __ldg(reinterpret_cast<const float4*>(out + off))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kSlots; ++u)
      if (on[u]) pick4(ov[u], xc, hv[u], acc);
  }
}

// The gather of the transpose rows of block bx (L lanes a row, G rows a
// warp) over the columns c0 .. c0 + 4 L.
__device__ __forceinline__ void bwd_rows(const int32_t* __restrict__ cols,
                                         const float* __restrict__ vals,
                                         const int32_t* __restrict__ ovf_ptr,
                                         const int32_t* __restrict__ ovf_cols,
                                         const float* __restrict__ ovf_vals,
                                         const float* __restrict__ h,
                                         const float* __restrict__ out,
                                         const float* __restrict__ x, float* __restrict__ dx,
                                         int64_t C, int K, int D, int L, int G, int64_t bx,
                                         int c0) {
  const int lane = threadIdx.x & 31;
  const int64_t r0 = (bx * kWarpsPerBlock + (threadIdx.x >> 5)) * G;
  if (r0 >= C) return;  // uniform across the warp
  const int grp = lane / L;
  const int l = lane - grp * L;
  const int base = grp * L;
  const unsigned gmask = (L == 32 ? kFull : (1u << L) - 1u) << base;
  const int64_t r = r0 + grp;
  const bool live = grp < G && r < C;
  const int64_t rr = live ? r : 0;
  const int d = c0 + 4 * l;
  const bool dl = live && d < D;
  const float4 xc = dl ? __ldg(reinterpret_cast<const float4*>(x + rr * D + d))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  float acc[4] = {};
  float tail[4] = {};

  const int32_t* cr = cols + rr * K;
  const float* vr = vals + rr * K;
  for (int kb = 0; kb < K; kb += L) {
    const bool ok = live && kb + l < K;
    bwd_chunk(ok ? cr[kb + l] : 0, ok ? vr[kb + l] : 0.f, ok, base, gmask, h, out, D, d, dl,
              xc, acc);
  }
  const int p0 = live ? ovf_ptr[rr] : 0;
  const int len = live ? ovf_ptr[rr + 1] - p0 : 0;
  const int longest = __reduce_max_sync(kFull, len);
  for (int kb = 0; kb < longest; kb += L) {
    const bool ok = kb + l < len;
    bwd_chunk(ok ? ovf_cols[p0 + kb + l] : 0, ok ? ovf_vals[p0 + kb + l] : 0.f, ok, base,
              gmask, h, out, D, d, dl, xc, tail);
  }
  if (dl)
    *reinterpret_cast<float4*>(dx + rr * D + d) =
        make_float4(acc[0] + tail[0], acc[1] + tail[1], acc[2] + tail[2], acc[3] + tail[3]);
}

// The backward's last (or only) gather: the columns c0 .. c0 + 4 L.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
hybrid_max_bwd_vec_kernel(const int32_t* __restrict__ cols, const float* __restrict__ vals,
                          const int32_t* __restrict__ ovf_ptr,
                          const int32_t* __restrict__ ovf_cols,
                          const float* __restrict__ ovf_vals, const float* __restrict__ h,
                          const float* __restrict__ out, const float* __restrict__ x,
                          float* __restrict__ dx, int64_t C, int K, int D, int L, int G,
                          int c0) {
  bwd_rows(cols, vals, ovf_ptr, ovf_cols, ovf_vals, h, out, x, dx, C, K, D, L, G, blockIdx.x,
           c0);
}

// One step of the chunked backward (chunks of 128 columns, one warp a
// row): blocks [0, bh) write h = (deg_fwd > 0 ? g : 0) / ties over the
// chunk at hc, one float4 a lane; the others (if any) gather the chunk at
// c0, whose h the step before wrote.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
max_bwd_step_kernel(const float* __restrict__ g, const float* __restrict__ ties,
                    const float* __restrict__ deg, float* __restrict__ h, int64_t R, int hc,
                    int64_t bh, const int32_t* __restrict__ cols,
                    const float* __restrict__ vals, const int32_t* __restrict__ ovf_ptr,
                    const int32_t* __restrict__ ovf_cols, const float* __restrict__ ovf_vals,
                    const float* __restrict__ out, const float* __restrict__ x,
                    float* __restrict__ dx, int64_t C, int K, int D, int c0) {
  if ((int64_t)blockIdx.x >= bh) {
    bwd_rows(cols, vals, ovf_ptr, ovf_cols, ovf_vals, h, out, x, dx, C, K, D, 32, 1,
             (int64_t)blockIdx.x - bh, c0);
    return;
  }
  const int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int d = hc + 4 * (threadIdx.x & 31);
  if (r >= R || d >= D) return;
  const bool has = deg[r] > 0.f;
  const float4 gv = __ldg(reinterpret_cast<const float4*>(g + r * D + d));
  const float4 tv = __ldg(reinterpret_cast<const float4*>(ties + r * D + d));
  *reinterpret_cast<float4*>(h + r * D + d) =
      make_float4((has ? gv.x : 0.f) / tv.x, (has ? gv.y : 0.f) / tv.y,
                  (has ? gv.z : 0.f) / tv.z, (has ? gv.w : 0.f) / tv.w);
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
  } else if (D <= kFwdChunk) {  // one warp per row, two float4 per lane
    hybrid_max_vec_kernel<2><<<dim3(blocks_for(R), 1), block, 0, s>>>(
        c, v, op, oc, ov, dg, xf, of, tf, R, K, D, (D / 4 + 1) / 2, 1);
  } else {  // kFwdChunk-column chunks
    const unsigned chunks = (D + kFwdChunk - 1) / kFwdChunk;
    hybrid_max_vec_kernel<2><<<dim3(blocks_for(R), chunks), block, 0, s>>>(
        c, v, op, oc, ov, dg, xf, of, tf, R, K, D, 32, 1);
  }
  return (int)cudaGetLastError();
}

// The tables are the transpose's (C rows, K slots naming forward rows);
// g, ties, out and h are [R_fwd, D], deg_fwd [R_fwd], x and dx [C, D]; h is
// scratch that the caller allocates.  The vector path launches one step a
// kBwdChunk-column chunk (max_bwd_step_kernel; the first writes h alone)
// and then the last chunk's gather (hybrid_max_bwd_vec_kernel):
// ceil(D / kBwdChunk) + 1 launches, fixed by D.
extern "C" int hybrid_max_bwd_f32(const void* cols, const void* vals, const void* ovf_ptr,
                                  const void* ovf_cols, const void* ovf_vals, const void* g,
                                  const void* ties, const void* out, const void* deg_fwd,
                                  const void* x, void* h, void* dx, int64_t C, int K, int D,
                                  int64_t R_fwd, void* stream) {
  if (C <= 0 || K < 0 || D <= 0 || R_fwd <= 0 || ovf_ptr == nullptr)
    return (int)cudaErrorInvalidValue;
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* c = (const int32_t*)cols;
  const float* v = (const float*)vals;
  const int32_t* op = (const int32_t*)ovf_ptr;
  const int32_t* oc = (const int32_t*)ovf_cols;
  const float* ov = (const float*)ovf_vals;
  const float* gf = (const float*)g;
  const float* tf = (const float*)ties;
  const float* dg = (const float*)deg_fwd;
  float* hf = (float*)h;
  const float* of = (const float*)out;
  const float* xf = (const float*)x;
  float* df = (float*)dx;
  const bool vec = D % 4 == 0 && aligned(g) && aligned(ties) && aligned(h) && aligned(out) &&
                   aligned(x) && aligned(dx);
  if (!vec) {
    max_bwd_scale_kernel<<<blocks_for(R_fwd), block, 0, s>>>(gf, tf, dg, hf, R_fwd, D);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    hybrid_max_bwd_scalar_kernel<<<dim3(blocks_for(C), (D + kChunk - 1) / kChunk), block, 0,
                                   s>>>(c, v, op, oc, ov, hf, of, xf, df, C, K, D);
    return (int)cudaGetLastError();
  }
  const int chunks = (D + kBwdChunk - 1) / kBwdChunk;
  const int64_t bh = blocks_for(R_fwd);
  const unsigned bg = blocks_for(C);
  for (int j = 0; j < chunks; ++j) {  // h of chunk j beside the gather of chunk j - 1
    max_bwd_step_kernel<<<(unsigned)(bh + (j ? bg : 0)), block, 0, s>>>(
        gf, tf, dg, hf, R_fwd, j * kBwdChunk, bh, c, v, op, oc, ov, of, xf, df, C, K, D,
        (j - 1) * kBwdChunk);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (D <= kBwdChunk) {  // ceil(D/4) lanes per row, several rows per warp
    const int L = D / 4;
    const int G = 32 / L;
    hybrid_max_bwd_vec_kernel<<<blocks_for((C + G - 1) / G), block, 0, s>>>(
        c, v, op, oc, ov, hf, of, xf, df, C, K, D, L, G, 0);
  } else {
    hybrid_max_bwd_vec_kernel<<<bg, block, 0, s>>>(c, v, op, oc, ov, hf, of, xf, df, C, K, D,
                                                   32, 1, (chunks - 1) * kBwdChunk);
  }
  return (int)cudaGetLastError();
}

// The vector paths' column chunk: the forward's (backward == 0) or the
// backward's.
extern "C" int hybrid_max_chunk_cols(int backward) { return backward ? kBwdChunk : kFwdChunk; }
