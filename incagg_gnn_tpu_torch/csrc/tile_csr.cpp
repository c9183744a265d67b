// Host build of the dense tier's tile-CSR form (ops/block.py::BlockDense).
//
// The JAX package's blocks_fill (csrc/graph_ops.cpp) writes every edge of a
// block holding >= thresh edges into a dense [rb, 128] tile and the other
// edges into a remainder CSR.  tile_csr_fill makes the same assignment of
// edges to tiles without the dense tile buffer: it writes the tile list's
// column blocks, the remainder, and for every row the tiles' nonzero cells
// as (column, value) entries in ascending column order.  Duplicate edges of
// a cell are summed from zero in CSR order, as blocks_fill adds them into
// its zeroed tile (f32 +=, or bf16 rounded to nearest even after each add),
// and a cell whose bits come out zero is dropped.
//
// Build: g++ -O3 -fopenmp -shared -fPIC (utils/native.py does it on first
// use).  Parallel over row-blocks, whose output ranges are disjoint.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

inline uint16_t f32_to_bf16(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  x += 0x7FFFu + ((x >> 16) & 1);  // round to nearest even
  return (uint16_t)(x >> 16);
}

inline float bf16_to_f32(uint16_t b) {
  const uint32_t x = (uint32_t)b << 16;
  float f;
  std::memcpy(&f, &x, 4);
  return f;
}

}  // namespace

extern "C" {

// rowptr/col/value: the CSR (value may be null: weight 1).  tile_start[nrb]:
// the padded start of each row-block's tile run; rem_rowptr[r+1]: remainder
// offsets; ent_rowptr[r+1]: per-row room for entries (the row's edges in
// tiles).  Writes bcol_out at tile_start[rb] + slot, the remainder, and each
// row's entries at ent_rowptr[i], compacted afterwards so that row i's
// entries start at out_rowptr[i].  Returns the number of entries.
int64_t tile_csr_fill(const int64_t* rowptr, const int32_t* col,
                      const float* value, int64_t r, int64_t ncb,
                      int64_t thresh, int64_t rb_rows,
                      const int64_t* tile_start, const int64_t* rem_rowptr,
                      const int64_t* ent_rowptr, int32_t bf16,
                      int32_t* bcol_out, int32_t* rem_col, float* rem_val,
                      int32_t* ent_col, void* ent_val, int64_t* out_rowptr) {
  const int64_t nrb = (r + rb_rows - 1) / rb_rows;
  std::vector<int64_t> count(r, 0);
#pragma omp parallel
  {
    std::vector<int32_t> cnt(ncb, 0);
    std::vector<int32_t> touched;
    std::vector<std::pair<int32_t, float>> cells;  // one row's tile edges
#pragma omp for schedule(dynamic, 4)
    for (int64_t rb = 0; rb < nrb; ++rb) {
      const int64_t r0 = rb * rb_rows, r1 = std::min<int64_t>(r0 + rb_rows, r);
      touched.clear();
      for (int64_t j = rowptr[r0]; j < rowptr[r1]; ++j) {
        const int32_t cb = col[j] >> 7;
        if (cnt[cb]++ == 0) touched.push_back(cb);
      }
      std::sort(touched.begin(), touched.end());
      int64_t slot = tile_start[rb];
      for (int32_t cb : touched)
        if (cnt[cb] >= thresh) bcol_out[slot++] = cb;
      for (int64_t i = r0; i < r1; ++i) {
        int64_t rc = rem_rowptr[i];
        cells.clear();
        for (int64_t j = rowptr[i]; j < rowptr[i + 1]; ++j) {
          const int32_t c = col[j];
          const float v = value ? value[j] : 1.0f;
          if (cnt[c >> 7] >= thresh) {
            cells.emplace_back(c, v);
          } else {
            rem_col[rc] = c;
            rem_val[rc] = v;
            ++rc;
          }
        }
        // ascending column; duplicates keep their CSR order
        std::stable_sort(cells.begin(), cells.end(),
                         [](const std::pair<int32_t, float>& a,
                            const std::pair<int32_t, float>& b) {
                           return a.first < b.first;
                         });
        int64_t e = ent_rowptr[i];
        for (size_t k = 0; k < cells.size();) {
          const int32_t c = cells[k].first;
          float f = 0.0f;
          uint16_t h = 0;
          for (; k < cells.size() && cells[k].first == c; ++k) {
            if (bf16)
              h = f32_to_bf16(bf16_to_f32(h) + cells[k].second);
            else
              f += cells[k].second;
          }
          uint32_t bits;
          std::memcpy(&bits, &f, 4);
          if (bf16 ? h == 0 : bits == 0) continue;  // the cell cancelled
          ent_col[e] = c;
          if (bf16)
            ((uint16_t*)ent_val)[e] = h;
          else
            ((float*)ent_val)[e] = f;
          ++e;
        }
        count[i] = e - ent_rowptr[i];
      }
      for (int32_t cb : touched) cnt[cb] = 0;
    }
  }
  // compact the rows' entries to their final offsets (never forward)
  int64_t w = 0;
  out_rowptr[0] = 0;
  for (int64_t i = 0; i < r; ++i) {
    const int64_t src = ent_rowptr[i];
    if (w != src) {
      std::memmove(ent_col + w, ent_col + src, count[i] * sizeof(int32_t));
      if (bf16)
        std::memmove((uint16_t*)ent_val + w, (uint16_t*)ent_val + src,
                     count[i] * sizeof(uint16_t));
      else
        std::memmove((float*)ent_val + w, (float*)ent_val + src,
                     count[i] * sizeof(float));
    }
    w += count[i];
    out_rowptr[i + 1] = w;
  }
  return w;
}

}  // extern "C"
