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
// The lane groups, loads in flight and tail walk are the ones above, and
// so is the bound, plus the values' bytes.  A slot is taken when any of its
// heads' values is nonzero, so padding (zero in every head) is never read;
// a head whose value is zero in a taken slot adds 0 * x, exact for finite
// x.  What the heads add to kernel B's work is the values: read per slot
// (H 4-byte loads a lane for the "any head" bit before each chunk's ballot,
// then one load of its own head's value beside each x row), they cost
// GAT arxiv's forward 29% and its transpose 51% over kernel B on the same
// gathers.  So where H is 2, 4 or 8 and divides the lanes of a group
// (chosen in ell_spmm_heads_f32), a chunk's values are read once, coalesced:
// group lane l holds element q * L + l of the chunk's flat [slots, H] block
// in register q (ceil(slots * H / L) loads a lane a chunk), the "any head"
// bits come from H ballots folded H bits to one, and a lane takes its
// head's value for slot j by one shuffle from register (j * H) / L of
// group lane (j * H) % L + head (a register chosen per lane where a warp
// holds several groups).  The slots and the order of the sum are the same
// as with the values read per slot, so the two agree bit for bit.  Other
// H, and the scalar path, read them per slot.  H = 1 never comes here: the
// wrapper sends it to ell_spmm_f32, the same table without the head axis.
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
// Bound: the bytes above, the rows at their stored width.  What held the
// fp8 rows back was how few warps an SM held, not their bytes: GCNII
// products' fp8 batch took what its bf16 batch took, on two thirds of the
// bytes.  Eight 16-value pieces in flight took 102 registers a thread (two
// blocks of 8 warps an SM); fp8 rows keep four in flight, at 75 registers
// (three blocks), and sum the slots in the same order.  Splitting a narrow
// row's slots among the warp's groups lost on a batch that fills the card:
// G rows a warp already share each warp instruction among G slots, and the
// split only adds the shuffles that add the groups' partials.

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
  static constexpr int kLoads = kLoadsInFlight;
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
  static constexpr int kLoads = kLoadsInFlight;
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
  // half of the others' loads in flight: 75 registers a thread, not 102,
  // at one piece a lane, so three blocks of 8 warps fit an SM, not two
  static constexpr int kLoads = kLoadsInFlight / 2;
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
  constexpr int kSlots = Row<T>::kLoads / kVecs;  // slots whose gathers go together
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

// Bit s of the result: any of bits s * kH .. s * kH + kH - 1 of b (kH a
// power of two up to 8); a ballot of kH values a slot, one bit a slot.
template <int kH>
__device__ __forceinline__ unsigned fold_heads(unsigned b) {
  static_assert(kH == 2 || kH == 4 || kH == 8, "kH: 2, 4 or 8");
  b |= b >> 1;
  if constexpr (kH >= 4) b |= b >> 2;
  if constexpr (kH == 8) b |= b >> 4;
  if constexpr (kH == 2) {
    b &= 0x55555555u;
    b = (b | b >> 1) & 0x33333333u;
    b = (b | b >> 2) & 0x0f0f0f0fu;
    b = (b | b >> 4) & 0x00ff00ffu;
    return (b | b >> 8) & 0x0000ffffu;
  } else if constexpr (kH == 4) {
    b &= 0x11111111u;
    b = (b | b >> 3) & 0x03030303u;
    b = (b | b >> 6) & 0x000f000fu;
    return (b | b >> 12) & 0x000000ffu;
  } else {
    b &= 0x01010101u;
    b = (b | b >> 7) & 0x00030003u;
    return (b | b >> 14) & 0x0000000fu;
  }
}

// The heads form's chunk of candidate slots: lane base + j of a group holds
// slot j's column.  Where the values are read per slot (kH == 0), ``any``
// says whether slot j has a nonzero head and a lane loads its own head's
// value beside each x row, from ``vs`` (the chunk's first slot's H values).
// Where they are read once a chunk (kH == H), ``vq`` holds the chunk's flat
// [slots, H] value block, element q * L + l in register q of group lane l
// (H divides L, so a slot's H values lie in one register), and a lane takes
// its head's value for slot j from that register of group lane (j * H) % L
// + head by a shuffle.  The slots and the sum's order are the same either way.
template <int kVecs, int kH>
__device__ __forceinline__ void gather_chunk_heads(int32_t c, bool any,
                                                   const float (&vq)[kH > 0 ? kH : 1],
                                                   int L, int spr, unsigned spr_inv, int base,
                                                   unsigned gmask,
                                                   const float* __restrict__ vs, int H,
                                                   const int (&hv)[kVecs],
                                                   const float* __restrict__ x, int D,
                                                   const int (&dv)[kVecs],
                                                   const bool (&dl)[kVecs],
                                                   float (&acc)[kVecs][4]) {
  constexpr int kSlots = kLoadsInFlight / kVecs;
  unsigned bits;
  if constexpr (kH == 0) {
    bits = (__ballot_sync(kFull, any) & gmask) >> base;
  } else {
    // bit q * spr + s: slot q * spr + s (spr = L / H slots a register) has
    // a nonzero head; a register's ballot holds H bits a slot, folded to one
    bits = 0;
#pragma unroll
    for (int q = 0; q < kH; ++q)
      bits |= fold_heads<kH>((__ballot_sync(kFull, vq[q] != 0.f) & gmask) >> base)
              << (q * spr);
  }
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
      if constexpr (kH > 0) {
        const int q = (int)(((unsigned)j * spr_inv) >> 16);  // j / spr
        float vr = vq[0];
#pragma unroll
        for (int t = 1; t < kH; ++t) vr = q == t ? vq[t] : vr;
        const int src = base + (j - q * spr) * kH;
#pragma unroll
        for (int p = 0; p < kVecs; ++p) vj[u][p] = __shfl_sync(kFull, vr, src + hv[p]);
      }
#pragma unroll
      for (int p = 0; p < kVecs; ++p) {
        const bool go = on[u] && dl[p];
        if constexpr (kH == 0) vj[u][p] = go ? __ldg(vs + (int64_t)j * H + hv[p]) : 0.f;
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

// A chunk's heads-form values as gather_chunk_heads takes them: the lane's
// slot's any-head bit (per slot), or its elements of the chunk's flat value
// block, ``n`` slots from ``vs`` (once a chunk).
template <int kH>
__device__ __forceinline__ bool chunk_values(const float* __restrict__ vs, int n, int l,
                                             int L, int H, float (&vq)[kH > 0 ? kH : 1]) {
  if constexpr (kH == 0) {
    return l < n && any_head(vs + (int64_t)l * H, H);
  } else {
#pragma unroll
    for (int q = 0; q < kH; ++q) {
      const int e = q * L + l;
      vq[q] = e < n * kH ? __ldg(vs + e) : 0.f;
    }
    return false;
  }
}

// The vector path of the heads form: the layout of ell_spmm_vec_kernel, Dh a
// multiple of 4 (a float4 never straddles two heads); kH the heads when the
// values are read once a chunk, 0 when per slot.
template <int kVecs, int kH>
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
  const int spr = L / (kH > 0 ? kH : 1);               // slots a value register
  const unsigned spr_inv = (65536u + spr - 1) / spr;  // j / spr = j * spr_inv >> 16, j < 32
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
  float vq[kH > 0 ? kH : 1];

  const int64_t rr = live ? r : 0;
  const int32_t* cr = cols + rr * K;
  const float* vr = vals + rr * K * H;
  for (int kb = 0; kb < K; kb += L) {
    const bool ok = live && kb + l < K;
    const float* vs = vr + (int64_t)kb * H;
    const bool any = chunk_values<kH>(vs, live ? min(L, K - kb) : 0, l, L, H, vq);
    gather_chunk_heads<kVecs, kH>(ok ? cr[kb + l] : 0, any, vq, L, spr, spr_inv, base,
                                  gmask, vs, H, hv, x, D, dv, dl, acc);
  }
  if (ovf_ptr != nullptr) {  // uniform: the fused call
    const int p0 = live ? ovf_ptr[rr] : 0;
    const int len = live ? ovf_ptr[rr + 1] - p0 : 0;
    const int longest = __reduce_max_sync(kFull, len);
    for (int kb = 0; kb < longest; kb += L) {
      const bool ok = kb + l < len;
      const float* vs = ovf_vals + (int64_t)(p0 + kb) * H;
      const bool any = chunk_values<kH>(vs, max(0, min(L, len - kb)), l, L, H, vq);
      gather_chunk_heads<kVecs, kH>(ok ? ovf_cols[p0 + kb + l] : 0, any, vq, L, spr,
                                    spr_inv, base, gmask, vs, H, hv, x, D, dv, dl, tail);
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

namespace {

// The heads form's vector path at kVecs float4 a lane: L lanes a row, G rows
// a warp, blockIdx.y over 256-column chunks; the values read per slot
// (kH == 0) or once a chunk (kH == H).
template <int kVecs, int kH>
void launch_heads(const int32_t* c, const float* v, const int32_t* op, const int32_t* oc,
                  const float* ov, const float* x, float* out, int64_t R, int K, int D,
                  int H, int Dh, int L, int G, int chunks, cudaStream_t s) {
  ell_spmm_heads_vec_kernel<kVecs, kH>
      <<<dim3(blocks_for((R + G - 1) / G), chunks), kWarpsPerBlock * 32, 0, s>>>(
          c, v, op, oc, ov, x, out, R, K, D, H, Dh, L, G);
}

template <int kVecs>
void launch_heads(bool per_chunk, const int32_t* c, const float* v, const int32_t* op,
                  const int32_t* oc, const float* ov, const float* x, float* out, int64_t R,
                  int K, int D, int H, int Dh, int L, int G, int chunks, cudaStream_t s) {
  if (!per_chunk) {
    launch_heads<kVecs, 0>(c, v, op, oc, ov, x, out, R, K, D, H, Dh, L, G, chunks, s);
  } else if (H == 2) {
    launch_heads<kVecs, 2>(c, v, op, oc, ov, x, out, R, K, D, H, Dh, L, G, chunks, s);
  } else if (H == 4) {
    launch_heads<kVecs, 4>(c, v, op, oc, ov, x, out, R, K, D, H, Dh, L, G, chunks, s);
  } else {
    launch_heads<kVecs, 8>(c, v, op, oc, ov, x, out, R, K, D, H, Dh, L, G, chunks, s);
  }
}

// The heads form; ``per_slot`` keeps the values read per slot whatever H.
int heads(const void* cols, const void* vals, const void* ovf_ptr, const void* ovf_cols,
          const void* ovf_vals, const void* x, void* out, int64_t R, int K, int H, int Dh,
          void* stream, bool per_slot) {
  if (R <= 0 || K < 0 || H <= 0 || Dh <= 0) return (int)cudaErrorInvalidValue;
  const int D = H * Dh;
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
    ell_spmm_heads_scalar_kernel<<<dim3(blocks_for(R), (D + kChunk - 1) / kChunk),
                                   kWarpsPerBlock * 32, 0, s>>>(c, v, op, oc, ov, xf, of, R,
                                                                K, D, H, Dh);
    return (int)cudaGetLastError();
  }
  // lanes a row: one float4 each up to 128 columns, two up to 256, then
  // 32 lanes in 256-column chunks; a chunk's values are read once where H
  // is 2, 4 or 8 and divides them (a slot's H values in one register)
  const int L = D <= 128 ? D / 4 : D <= 256 ? (D / 4 + 1) / 2 : 32;
  const bool per_chunk = !per_slot && (H == 2 || H == 4 || H == 8) && L % H == 0;
  if (D <= 128) {
    launch_heads<1>(per_chunk, c, v, op, oc, ov, xf, of, R, K, D, H, Dh, L, 32 / L, 1, s);
  } else {
    launch_heads<2>(per_chunk, c, v, op, oc, ov, xf, of, R, K, D, H, Dh, L, 1,
                    (D + 255) / 256, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The heads form: vals [R, K, H], ovf_vals [O, H], x and out [., H * Dh];
// ovf_ptr == nullptr: the ELL core alone.
extern "C" int ell_spmm_heads_f32(const void* cols, const void* vals, const void* ovf_ptr,
                                  const void* ovf_cols, const void* ovf_vals,
                                  const void* x, void* out, int64_t R, int K, int H,
                                  int Dh, void* stream) {
  return heads(cols, vals, ovf_ptr, ovf_cols, ovf_vals, x, out, R, K, H, Dh, stream, false);
}

// The same with the values read per slot at every H: for tests, which hold
// the values read once a chunk to it bit for bit.
extern "C" int ell_spmm_heads_f32_per_slot(const void* cols, const void* vals,
                                           const void* ovf_ptr, const void* ovf_cols,
                                           const void* ovf_vals, const void* x, void* out,
                                           int64_t R, int K, int H, int Dh, void* stream) {
  return heads(cols, vals, ovf_ptr, ovf_cols, ovf_vals, x, out, R, K, H, Dh, stream, true);
}
