// Kernel B: the hybrid aggregation's ELL gather-multiply-reduce, with the
// overflow tail of each row summed in the same launch:
//
//   out[r] = sum_k vals[r,k] * x[cols[r,k]]
//          + sum_{e in [ovf_ptr[r], ovf_ptr[r+1])} ovf_vals[e] * x[ovf_cols[e]]
//
// Replaces incagg_gnn_tpu/ops/pallas_spmm.py::pallas_spmm_ell_vmem, the
// Pallas blueprint whose in-kernel gather never lowered on the TPU (the JAX
// package computes the same sum in XLA, ops/ell.py::_ell_sum), together with
// the XLA segment_sum that adds the row-sorted COO overflow
// (ops/ell.py::spmm_hybrid): the ELL sum and the tail sum are kept in two
// f32 accumulators and written as ell_sum + tail_sum, the reference's
// association.  Without a row pointer (ovf_ptr == nullptr) it is the ELL
// core alone: the extension levels and the incidence path call it so.
// cols [R, K] int32, vals [R, K] f32, ovf_ptr [R + 1] int32 over ovf_cols /
// ovf_vals (one row's tail contiguous, rows ascending; the builders leave
// the overflow's padding entries out of the pointer), x [C, D] f32,
// out [R, D] f32; any R, K >= 0.
//
// Bound.  Memory: each real slot reads one x row (D*4 bytes, scattered,
// mostly from L2) for 2*D flops, far below the card's flop/byte balance, so
// what counts is the bytes gathered and the gathers in flight.  Design:
// - Only real slots cost a gather.  A group of lanes reads its row's
//   (col, val) pairs with one coalesced load per chunk, ballots val != 0 and
//   walks the set bits in ascending slot order; padding (weight 0, the trash
//   column) costs no load and no FMA.  This equals the plain version for
//   finite x (a zero-weighted term adds nothing); it differs only where x
//   holds inf or NaN in a row that only padding names.
// - A group covers a whole row: 128 < D <= 256 one warp per row with two
//   float4 per lane, D <= 128 ceil(D/4) lanes of one float4 each, and a warp
//   serves floor(32 / lanes) rows (D40: 10 lanes, three rows, 2 lanes idle),
//   so a row's pairs are read once.  Wider D (no path of the port passes it)
//   takes 256-column chunks across blockIdx.y, each reading the pairs again.
// - Eight 16-byte gathers per lane are issued before their FMAs: eight
//   slots at D <= 128, four at 128 < D <= 256 (two float4 each).  Eight
//   slots of two float4 took 74 registers a thread and ran slower there.
// - The tail needs no [O, D] intermediate, no atomics and no copy of out:
//   the warp that owns a row walks its tail after its ELL slots.  A row's
//   tail is one warp's work, so a very long tail runs serially.
// A scalar path (one warp per row and 128 columns, one slot at a time)
// takes D not a multiple of 4 or an x off a 16-byte boundary.
//
// Heads form (ell_spmm_heads_f32, GAT's attention-weighted message sum and
// its transposed backward): x is [C, H*Dh] and each slot carries H values,
// vals [R, K, H] and ovf_vals [O, H] (the tail's in ovf_ptr order); column
// d takes head d / Dh's value:
//
//   out[r, h*Dh:(h+1)*Dh] = sum_k vals[r,k,h] * x[cols[r,k], h*Dh:(h+1)*Dh]
//                         + (the tail, the same way)
//
// The lane groups, loads in flight and tail walk are the ones above.  The
// ballot takes a slot when any of its heads' values is nonzero, so padding
// (zero in every head) is never read; a lane then reads the value of its
// own columns' head beside the x row (one 4-byte load that the group's
// lanes of one head share).  A head whose value is zero in a taken slot
// adds 0 * x, exact for finite x.  H = 1 never comes here: the wrapper
// sends it to ell_spmm_f32, the same table without the head axis.
//
// Storage-dtype form (ell_spmm_table, the refresh sweep over global-column
// batches): the fused call with x a history cache table, [N+1, D] rows of
// f32, bf16, float8_e4m3fn or float8_e5m2, and the batch's columns rows of
// that table (the eval loader's global_cols), as the JAX package's
// models/base.py::_refresh_batch_step_global aggregates over the table in
// its dtype.  Unlike the JAX step, values and sums stay f32, so a row is
// rounded once, where the cache stored it.  The kernels above are
// templated on the row type (Row<T>): every lane loads 16 bytes of a row
// at a time (4 f32, 8 bf16 or 16 fp8 values) and converts them in
// registers (bf16: a shift; fp8: the hardware's paired fp8 -> f16
// conversion, exact, then f16 -> f32).  ceil(D / values-per-16-bytes)
// lanes cover a row when that is at most 32 (fp8 D128: 8 lanes, four rows a
// warp), two pieces a lane up to 64, and 64-piece chunks across blockIdx.y
// beyond; the f32 instance is the layout above.  The scalar path takes D
// not a multiple of a piece or a table off a 16-byte boundary.  Row offsets
// are int64: a table row index times D exceeds 2^31 at products scale.

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kLoadsInFlight = 8;  // 16-byte gathers a lane issues before their FMAs
constexpr int kChunk = 128;   // columns per warp on the scalar path

// Row types: what one 16-byte piece of an x row holds, and how it becomes
// f32.  kF32 is the plain f32 table of every fused and core call; the
// others serve the storage-dtype form (ell_spmm_table).
enum RowType { kF32 = 0, kBF16 = 1, kE4M3 = 2, kE5M2 = 3 };

template <int T>
struct Row;

template <>
struct Row<kF32> {
  using Elem = float;
  static constexpr int kPer = 4;
  static __device__ __forceinline__ void unpack(const uint4 u, float (&f)[kPer]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ float one(const Elem e) { return e; }
};

template <>
struct Row<kBF16> {
  using Elem = uint16_t;  // the bits; element 2i is the low half of word i
  static constexpr int kPer = 8;
  static __device__ __forceinline__ void unpack(const uint4 u, float (&f)[kPer]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ float one(const Elem e) {
    return __uint_as_float((uint32_t)e << 16);
  }
};

__device__ __forceinline__ float2 fp8x2_to_float2(uint32_t two,
                                                  __nv_fp8_interpretation_t kind) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)two, kind);
  return __half22float2(__half2(h));
}

template <__nv_fp8_interpretation_t kKind>
struct Fp8Row {
  using Elem = uint8_t;  // element 4i + j is byte j of word i
  static constexpr int kPer = 16;
  static __device__ __forceinline__ void unpack(const uint4 u, float (&f)[kPer]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 lo = fp8x2_to_float2(w[i] & 0xffffu, kKind);
      const float2 hi = fp8x2_to_float2(w[i] >> 16, kKind);
      f[4 * i] = lo.x;
      f[4 * i + 1] = lo.y;
      f[4 * i + 2] = hi.x;
      f[4 * i + 3] = hi.y;
    }
  }
  static __device__ __forceinline__ float one(const Elem e) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)e, kKind)));
  }
};

template <>
struct Row<kE4M3> : Fp8Row<__NV_E4M3> {};
template <>
struct Row<kE5M2> : Fp8Row<__NV_E5M2> {};

// One chunk of candidate slots: lane base + j of a group holds slot j's
// (c, v) and whether it exists.  Every lane of the warp takes part; each
// group walks its own real slots, the warp as many steps as its busiest
// group needs.
template <int T, int kVecs>
__device__ __forceinline__ void gather_chunk(int32_t c, float v, bool ok, int base,
                                             unsigned gmask,
                                             const typename Row<T>::Elem* __restrict__ x,
                                             int D, const int (&dv)[kVecs],
                                             const bool (&dl)[kVecs],
                                             float (&acc)[kVecs][Row<T>::kPer]) {
  constexpr int kPer = Row<T>::kPer;
  constexpr int kSlots = kLoadsInFlight / kVecs;  // slots whose gathers go together
  unsigned bits = (__ballot_sync(kFull, ok && v != 0.f) & gmask) >> base;
  const int n = __reduce_max_sync(kFull, __popc(bits));
  for (int i = 0; i < n; i += kSlots) {
    float vj[kSlots];
    bool on[kSlots];
    uint4 xv[kSlots][kVecs];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      on[u] = bits != 0;
      const int src = base + (on[u] ? __ffs(bits) - 1 : 0);
      bits &= bits - 1;
      const int32_t cj = __shfl_sync(kFull, c, src);
      vj[u] = __shfl_sync(kFull, v, src);
      const typename Row<T>::Elem* row = x + (int64_t)cj * D;
#pragma unroll
      for (int p = 0; p < kVecs; ++p)
        xv[u][p] = on[u] && dl[p] ? __ldg(reinterpret_cast<const uint4*>(row + dv[p]))
                                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kSlots; ++u)
      if (on[u]) {
#pragma unroll
        for (int p = 0; p < kVecs; ++p) {
          float f[kPer];
          Row<T>::unpack(xv[u][p], f);
#pragma unroll
          for (int e = 0; e < kPer; ++e) acc[p][e] = fmaf(vj[u], f[e], acc[p][e]);
        }
      }
  }
}

// kVecs 16-byte pieces per lane; L lanes per row (the group), G rows per
// warp.  Lane l of a group covers columns c0 + (p * L + l) * kPer .. + kPer-1.
template <int T, int kVecs>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_spmm_vec_kernel(const int32_t* __restrict__ cols, const float* __restrict__ vals,
                    const int32_t* __restrict__ ovf_ptr,
                    const int32_t* __restrict__ ovf_cols,
                    const float* __restrict__ ovf_vals,
                    const typename Row<T>::Elem* __restrict__ x, float* __restrict__ out,
                    int64_t R, int K, int D, int L, int G) {
  constexpr int kPer = Row<T>::kPer;
  const int lane = threadIdx.x & 31;
  const int64_t r0 = ((int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * G;
  if (r0 >= R) return;  // uniform across the warp
  const int grp = lane / L;
  const int l = lane - grp * L;
  const int base = grp * L;
  const unsigned gmask = (L == 32 ? kFull : (1u << L) - 1u) << base;
  const int64_t r = r0 + grp;
  const bool live = grp < G && r < R;  // lanes past G * L serve no row
  const int c0 = blockIdx.y * L * kPer * kVecs;
  int dv[kVecs];
  bool dl[kVecs];
#pragma unroll
  for (int p = 0; p < kVecs; ++p) {
    dv[p] = c0 + (p * L + l) * kPer;
    dl[p] = live && dv[p] < D;
  }
  float acc[kVecs][kPer] = {};
  float tail[kVecs][kPer] = {};

  const int64_t rr = live ? r : 0;
  const int32_t* cr = cols + rr * K;
  const float* vr = vals + rr * K;
  for (int kb = 0; kb < K; kb += L) {
    const bool ok = live && kb + l < K;
    gather_chunk<T, kVecs>(ok ? cr[kb + l] : 0, ok ? vr[kb + l] : 0.f, ok, base, gmask, x,
                           D, dv, dl, acc);
  }
  if (ovf_ptr != nullptr) {  // uniform: the fused call
    const int p0 = live ? ovf_ptr[rr] : 0;
    const int len = live ? ovf_ptr[rr + 1] - p0 : 0;
    const int longest = __reduce_max_sync(kFull, len);
    for (int kb = 0; kb < longest; kb += L) {
      const bool ok = kb + l < len;
      gather_chunk<T, kVecs>(ok ? ovf_cols[p0 + kb + l] : 0,
                             ok ? ovf_vals[p0 + kb + l] : 0.f, ok, base, gmask, x, D, dv,
                             dl, tail);
    }
  }

  float* orow = out + rr * D;
#pragma unroll
  for (int p = 0; p < kVecs; ++p)
    if (dl[p]) {
#pragma unroll
      for (int q = 0; q < kPer; q += 4)
        *reinterpret_cast<float4*>(orow + dv[p] + q) =
            make_float4(acc[p][q] + tail[p][q], acc[p][q + 1] + tail[p][q + 1],
                        acc[p][q + 2] + tail[p][q + 2], acc[p][q + 3] + tail[p][q + 3]);
    }
}

// One chunk of up to 32 slots on the scalar path: the set bits one by one.
template <int T>
__device__ __forceinline__ void scalar_chunk(int32_t c, float v, bool ok, int lane, int c0,
                                             const typename Row<T>::Elem* __restrict__ x,
                                             int D, float (&acc)[4]) {
  unsigned bits = __ballot_sync(kFull, ok && v != 0.f);
  while (bits) {  // uniform: every lane holds the same bits
    const int j = __ffs(bits) - 1;
    bits &= bits - 1;
    const int32_t cj = __shfl_sync(kFull, c, j);
    const float vj = __shfl_sync(kFull, v, j);
    const typename Row<T>::Elem* row = x + (int64_t)cj * D;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int d = c0 + lane + 32 * q;
      if (d < D) acc[q] = fmaf(vj, Row<T>::one(__ldg(row + d)), acc[q]);
    }
  }
}

template <int T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_spmm_scalar_kernel(const int32_t* __restrict__ cols, const float* __restrict__ vals,
                       const int32_t* __restrict__ ovf_ptr,
                       const int32_t* __restrict__ ovf_cols,
                       const float* __restrict__ ovf_vals,
                       const typename Row<T>::Elem* __restrict__ x, float* __restrict__ out,
                       int64_t R, int K, int D) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;  // uniform across the warp
  const int c0 = blockIdx.y * kChunk;
  const int32_t* cr = cols + r * K;
  const float* vr = vals + r * K;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float tail[4] = {0.f, 0.f, 0.f, 0.f};
  for (int kb = 0; kb < K; kb += 32) {
    const bool ok = kb + lane < K;
    scalar_chunk<T>(ok ? cr[kb + lane] : 0, ok ? vr[kb + lane] : 0.f, ok, lane, c0, x, D,
                    acc);
  }
  if (ovf_ptr != nullptr) {
    const int p0 = ovf_ptr[r];
    const int len = ovf_ptr[r + 1] - p0;
    for (int kb = 0; kb < len; kb += 32) {
      const bool ok = kb + lane < len;
      scalar_chunk<T>(ok ? ovf_cols[p0 + kb + lane] : 0,
                      ok ? ovf_vals[p0 + kb + lane] : 0.f, ok, lane, c0, x, D, tail);
    }
  }
  float* orow = out + r * D;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int d = c0 + lane + 32 * q;
    if (d < D) orow[d] = acc[q] + tail[q];
  }
}

// One chunk of candidate slots in the heads form: lane base + j of a group
// holds slot j's column and whether any head of it is nonzero; ``vs`` points
// at the chunk's first slot's H values (the lane's own group's row).
template <int kVecs>
__device__ __forceinline__ void gather_chunk_heads(int32_t c, bool any, int base,
                                                   unsigned gmask,
                                                   const float* __restrict__ vs, int H,
                                                   const int (&hv)[kVecs],
                                                   const float* __restrict__ x, int D,
                                                   const int (&dv)[kVecs],
                                                   const bool (&dl)[kVecs],
                                                   float (&acc)[kVecs][4]) {
  constexpr int kSlots = kLoadsInFlight / kVecs;
  unsigned bits = (__ballot_sync(kFull, any) & gmask) >> base;
  const int n = __reduce_max_sync(kFull, __popc(bits));
  for (int i = 0; i < n; i += kSlots) {
    float vj[kSlots][kVecs];
    bool on[kSlots];
    float4 xv[kSlots][kVecs];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      on[u] = bits != 0;
      const int j = on[u] ? __ffs(bits) - 1 : 0;
      bits &= bits - 1;
      const int32_t cj = __shfl_sync(kFull, c, base + j);
      const float* row = x + (int64_t)cj * D;
      const float* v = vs + (int64_t)j * H;
#pragma unroll
      for (int p = 0; p < kVecs; ++p) {
        const bool go = on[u] && dl[p];
        vj[u][p] = go ? __ldg(v + hv[p]) : 0.f;
        xv[u][p] = go ? __ldg(reinterpret_cast<const float4*>(row + dv[p]))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < kSlots; ++u)
      if (on[u]) {
#pragma unroll
        for (int p = 0; p < kVecs; ++p) {
          acc[p][0] = fmaf(vj[u][p], xv[u][p].x, acc[p][0]);
          acc[p][1] = fmaf(vj[u][p], xv[u][p].y, acc[p][1]);
          acc[p][2] = fmaf(vj[u][p], xv[u][p].z, acc[p][2]);
          acc[p][3] = fmaf(vj[u][p], xv[u][p].w, acc[p][3]);
        }
      }
  }
}

__device__ __forceinline__ bool any_head(const float* __restrict__ v, int H) {
  bool any = false;
  for (int h = 0; h < H; ++h) any |= __ldg(v + h) != 0.f;
  return any;
}

// The vector path of the heads form: the layout of ell_spmm_vec_kernel, Dh a
// multiple of 4 (a float4 never straddles two heads).
template <int kVecs>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_spmm_heads_vec_kernel(const int32_t* __restrict__ cols, const float* __restrict__ vals,
                          const int32_t* __restrict__ ovf_ptr,
                          const int32_t* __restrict__ ovf_cols,
                          const float* __restrict__ ovf_vals,
                          const float* __restrict__ x, float* __restrict__ out,
                          int64_t R, int K, int D, int H, int Dh, int L, int G) {
  const int lane = threadIdx.x & 31;
  const int64_t r0 = ((int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * G;
  if (r0 >= R) return;  // uniform across the warp
  const int grp = lane / L;
  const int l = lane - grp * L;
  const int base = grp * L;
  const unsigned gmask = (L == 32 ? kFull : (1u << L) - 1u) << base;
  const int64_t r = r0 + grp;
  const bool live = grp < G && r < R;
  const int c0 = blockIdx.y * L * 4 * kVecs;
  int dv[kVecs], hv[kVecs];
  bool dl[kVecs];
#pragma unroll
  for (int p = 0; p < kVecs; ++p) {
    dv[p] = c0 + (p * L + l) * 4;
    dl[p] = live && dv[p] < D;
    hv[p] = dl[p] ? dv[p] / Dh : 0;
  }
  float acc[kVecs][4] = {};
  float tail[kVecs][4] = {};

  const int64_t rr = live ? r : 0;
  const int32_t* cr = cols + rr * K;
  const float* vr = vals + rr * K * H;
  for (int kb = 0; kb < K; kb += L) {
    const bool ok = live && kb + l < K;
    gather_chunk_heads<kVecs>(ok ? cr[kb + l] : 0, ok && any_head(vr + (int64_t)(kb + l) * H, H),
                              base, gmask, vr + (int64_t)kb * H, H, hv, x, D, dv, dl, acc);
  }
  if (ovf_ptr != nullptr) {  // uniform: the fused call
    const int p0 = live ? ovf_ptr[rr] : 0;
    const int len = live ? ovf_ptr[rr + 1] - p0 : 0;
    const int longest = __reduce_max_sync(kFull, len);
    for (int kb = 0; kb < longest; kb += L) {
      const bool ok = kb + l < len;
      const float* vs = ovf_vals + (int64_t)(p0 + kb) * H;
      gather_chunk_heads<kVecs>(ok ? ovf_cols[p0 + kb + l] : 0,
                                ok && any_head(vs + (int64_t)l * H, H), base, gmask, vs,
                                H, hv, x, D, dv, dl, tail);
    }
  }

  float* orow = out + rr * D;
#pragma unroll
  for (int p = 0; p < kVecs; ++p)
    if (dl[p])
      *reinterpret_cast<float4*>(orow + dv[p]) =
          make_float4(acc[p][0] + tail[p][0], acc[p][1] + tail[p][1],
                      acc[p][2] + tail[p][2], acc[p][3] + tail[p][3]);
}

// One chunk of up to 32 slots on the scalar path of the heads form.
__device__ __forceinline__ void scalar_chunk_heads(int32_t c, bool any, int lane, int c0,
                                                   const float* __restrict__ vs, int H,
                                                   const int (&hq)[4],
                                                   const float* __restrict__ x, int D,
                                                   float (&acc)[4]) {
  unsigned bits = __ballot_sync(kFull, any);
  while (bits) {  // uniform: every lane holds the same bits
    const int j = __ffs(bits) - 1;
    bits &= bits - 1;
    const int32_t cj = __shfl_sync(kFull, c, j);
    const float* row = x + (int64_t)cj * D;
    const float* v = vs + (int64_t)j * H;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int d = c0 + lane + 32 * q;
      if (d < D) acc[q] = fmaf(__ldg(v + hq[q]), __ldg(row + d), acc[q]);
    }
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_spmm_heads_scalar_kernel(const int32_t* __restrict__ cols,
                             const float* __restrict__ vals,
                             const int32_t* __restrict__ ovf_ptr,
                             const int32_t* __restrict__ ovf_cols,
                             const float* __restrict__ ovf_vals,
                             const float* __restrict__ x, float* __restrict__ out,
                             int64_t R, int K, int D, int H, int Dh) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;  // uniform across the warp
  const int c0 = blockIdx.y * kChunk;
  int hq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int d = c0 + lane + 32 * q;
    hq[q] = d < D ? d / Dh : 0;
  }
  const int32_t* cr = cols + r * K;
  const float* vr = vals + r * K * H;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float tail[4] = {0.f, 0.f, 0.f, 0.f};
  for (int kb = 0; kb < K; kb += 32) {
    const bool ok = kb + lane < K;
    scalar_chunk_heads(ok ? cr[kb + lane] : 0,
                       ok && any_head(vr + (int64_t)(kb + lane) * H, H), lane, c0,
                       vr + (int64_t)kb * H, H, hq, x, D, acc);
  }
  if (ovf_ptr != nullptr) {
    const int p0 = ovf_ptr[r];
    const int len = ovf_ptr[r + 1] - p0;
    for (int kb = 0; kb < len; kb += 32) {
      const bool ok = kb + lane < len;
      const float* vs = ovf_vals + (int64_t)(p0 + kb) * H;
      scalar_chunk_heads(ok ? ovf_cols[p0 + kb + lane] : 0,
                         ok && any_head(vs + (int64_t)lane * H, H), lane, c0, vs, H, hq,
                         x, D, tail);
    }
  }
  float* orow = out + r * D;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int d = c0 + lane + 32 * q;
    if (d < D) orow[d] = acc[q] + tail[q];
  }
}

unsigned blocks_for(int64_t warps) {
  return (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

template <int T>
void launch(const void* cols, const void* vals, const void* ovf_ptr, const void* ovf_cols,
            const void* ovf_vals, const void* x, void* out, int64_t R, int K, int D,
            cudaStream_t s) {
  using Elem = typename Row<T>::Elem;
  constexpr int kPer = Row<T>::kPer;
  const int32_t* c = (const int32_t*)cols;
  const float* v = (const float*)vals;
  const int32_t* op = (const int32_t*)ovf_ptr;
  const int32_t* oc = (const int32_t*)ovf_cols;
  const float* ov = (const float*)ovf_vals;
  const Elem* xe = (const Elem*)x;
  float* of = (float*)out;
  const dim3 block(kWarpsPerBlock * 32);
  // 16-byte row pieces need D % kPer == 0 and 16-byte aligned base pointers
  // (out's rows then start on 16 bytes too: D is a multiple of 4)
  const bool vec = D % kPer == 0 && ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const int pieces = D / kPer;
  if (!vec) {
    ell_spmm_scalar_kernel<T><<<dim3(blocks_for(R), (D + kChunk - 1) / kChunk), block, 0,
                                s>>>(c, v, op, oc, ov, xe, of, R, K, D);
  } else if (pieces <= 32) {  // one piece per lane, several rows per warp
    const int L = pieces;
    const int G = 32 / L;
    ell_spmm_vec_kernel<T, 1><<<dim3(blocks_for((R + G - 1) / G), 1), block, 0, s>>>(
        c, v, op, oc, ov, xe, of, R, K, D, L, G);
  } else if (pieces <= 64) {  // one warp per row, two pieces per lane
    ell_spmm_vec_kernel<T, 2><<<dim3(blocks_for(R), 1), block, 0, s>>>(
        c, v, op, oc, ov, xe, of, R, K, D, (pieces + 1) / 2, 1);
  } else {  // chunks of 64 pieces
    ell_spmm_vec_kernel<T, 2><<<dim3(blocks_for(R), (pieces + 63) / 64), block, 0, s>>>(
        c, v, op, oc, ov, xe, of, R, K, D, 32, 1);
  }
}

}  // namespace

// ovf_ptr == nullptr: the ELL core alone (ovf_cols, ovf_vals unread).
extern "C" int ell_spmm_f32(const void* cols, const void* vals, const void* ovf_ptr,
                            const void* ovf_cols, const void* ovf_vals, const void* x,
                            void* out, int64_t R, int K, int D, void* stream) {
  if (R <= 0 || K < 0 || D <= 0) return (int)cudaErrorInvalidValue;
  launch<kF32>(cols, vals, ovf_ptr, ovf_cols, ovf_vals, x, out, R, K, D,
               (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// The storage-dtype form: the fused call with x a table of row_type
// (0 f32, 1 bf16, 2 float8_e4m3fn, 3 float8_e5m2); out f32.
extern "C" int ell_spmm_table(int row_type, const void* cols, const void* vals,
                              const void* ovf_ptr, const void* ovf_cols,
                              const void* ovf_vals, const void* x, void* out, int64_t R,
                              int K, int D, void* stream) {
  if (R <= 0 || K < 0 || D <= 0 || ovf_ptr == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (row_type) {
    case kF32: launch<kF32>(cols, vals, ovf_ptr, ovf_cols, ovf_vals, x, out, R, K, D, s); break;
    case kBF16: launch<kBF16>(cols, vals, ovf_ptr, ovf_cols, ovf_vals, x, out, R, K, D, s); break;
    case kE4M3: launch<kE4M3>(cols, vals, ovf_ptr, ovf_cols, ovf_vals, x, out, R, K, D, s); break;
    case kE5M2: launch<kE5M2>(cols, vals, ovf_ptr, ovf_cols, ovf_vals, x, out, R, K, D, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The heads form: vals [R, K, H], ovf_vals [O, H], x and out [., H * Dh];
// ovf_ptr == nullptr: the ELL core alone.
extern "C" int ell_spmm_heads_f32(const void* cols, const void* vals, const void* ovf_ptr,
                                  const void* ovf_cols, const void* ovf_vals,
                                  const void* x, void* out, int64_t R, int K, int H,
                                  int Dh, void* stream) {
  if (R <= 0 || K < 0 || H <= 0 || Dh <= 0) return (int)cudaErrorInvalidValue;
  const int D = H * Dh;
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* c = (const int32_t*)cols;
  const float* v = (const float*)vals;
  const int32_t* op = (const int32_t*)ovf_ptr;
  const int32_t* oc = (const int32_t*)ovf_cols;
  const float* ov = (const float*)ovf_vals;
  const float* xf = (const float*)x;
  float* of = (float*)out;
  const bool vec = Dh % 4 == 0 && ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  if (!vec) {
    ell_spmm_heads_scalar_kernel<<<dim3(blocks_for(R), (D + kChunk - 1) / kChunk), block, 0,
                                   s>>>(c, v, op, oc, ov, xf, of, R, K, D, H, Dh);
  } else if (D <= 128) {
    const int L = D / 4;
    const int G = 32 / L;
    ell_spmm_heads_vec_kernel<1><<<dim3(blocks_for((R + G - 1) / G), 1), block, 0, s>>>(
        c, v, op, oc, ov, xf, of, R, K, D, H, Dh, L, G);
  } else if (D <= 256) {
    ell_spmm_heads_vec_kernel<2><<<dim3(blocks_for(R), 1), block, 0, s>>>(
        c, v, op, oc, ov, xf, of, R, K, D, H, Dh, (D / 4 + 1) / 2, 1);
  } else {
    ell_spmm_heads_vec_kernel<2><<<dim3(blocks_for(R), (D + 255) / 256), block, 0, s>>>(
        c, v, op, oc, ov, xf, of, R, K, D, H, Dh, 32, 1);
  }
  return (int)cudaGetLastError();
}
