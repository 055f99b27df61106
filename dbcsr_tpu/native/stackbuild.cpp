// Native planner core: fused tile-stack enumeration + sort + C-slot
// assignment.
//
// Counterpart of the reference's hot host-side index machinery:
// the csr stack builder (`dbcsr_mm_csr_multiply_low`,
// src/mm/dbcsr_mm_csr.F:178-360 — triple loop + per-row hash tables) and the
// stack sort/binning of the GPU driver (`stack_sort`/`stack_binning`,
// src/mm/dbcsr_mm_accdrv.F:364-386). Where the reference discovers C blocks
// with hash tables at user-block granularity, this enumerates
// (c_tile, a_tile, b_tile) triples over the hardware tile grids, sorts by
// output tile (deterministic accumulation order for the Pallas kernel) and
// assigns dense C-slot ids — one pass, no numpy temporaries.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Number of (c,a,b) triples of the tile product: sum_k na_k * nb_k.
// a_indptr: CSC-by-k pointer of A's tile pattern [kt+1]
// b_indptr: CSR-by-k pointer of B's tile pattern [kt+1]
int64_t dbcsr_stack_count(int64_t kt, const int64_t* a_indptr,
                          const int64_t* b_indptr) {
  int64_t total = 0;
  for (int64_t k = 0; k < kt; ++k) {
    total += (a_indptr[k + 1] - a_indptr[k]) * (b_indptr[k + 1] - b_indptr[k]);
  }
  return total;
}

// Enumerate all triples, sort by C tile (row-major key c_row*nt + c_col,
// ties kept in enumeration order => deterministic), assign dense C slots.
//
// Inputs:
//   kt, nt           tile-grid extents (K tiles, N tiles)
//   a_indptr[kt+1], a_rows[nnza], a_slots[nnza]   A pattern CSC-by-k
//   b_indptr[kt+1], b_cols[nnzb], b_slots[nnzb]   B pattern CSR-by-k
//   total            result of dbcsr_stack_count
// Outputs (caller-allocated):
//   stack[total*3]   int32 (c_slot, a_slot, b_slot) sorted by c_slot
//   c_keys[total]    int64 scratch; on return the first n_c entries hold
//                    the sorted unique C tile keys (row*nt + col)
// Returns n_c (number of distinct C tiles), or -1 on overflow.
int64_t dbcsr_stack_build(int64_t kt, int64_t nt, const int64_t* a_indptr,
                          const int64_t* a_rows, const int64_t* a_slots,
                          const int64_t* b_indptr, const int64_t* b_cols,
                          const int64_t* b_slots, int64_t total,
                          int32_t* stack, int64_t* c_keys) {
  struct Triple {
    int64_t ckey;
    int32_t a;
    int32_t b;
  };
  std::vector<Triple> triples;
  triples.reserve(static_cast<size_t>(total));
  for (int64_t k = 0; k < kt; ++k) {
    for (int64_t ia = a_indptr[k]; ia < a_indptr[k + 1]; ++ia) {
      const int64_t crow = a_rows[ia];
      const int64_t aslot = a_slots[ia];
      for (int64_t ib = b_indptr[k]; ib < b_indptr[k + 1]; ++ib) {
        triples.push_back(Triple{crow * nt + b_cols[ib],
                                 static_cast<int32_t>(aslot),
                                 static_cast<int32_t>(b_slots[ib])});
      }
    }
  }
  // stable: equal keys keep enumeration (k-ascending) order, matching the
  // reference's deterministic stack processing order
  std::stable_sort(triples.begin(), triples.end(),
                   [](const Triple& x, const Triple& y) {
                     return x.ckey < y.ckey;
                   });
  int64_t n_c = 0;
  int64_t prev = -1;
  for (int64_t i = 0; i < total; ++i) {
    const Triple& t = triples[static_cast<size_t>(i)];
    if (t.ckey != prev) {
      c_keys[n_c++] = t.ckey;
      prev = t.ckey;
    }
    if (n_c - 1 > INT32_MAX) return -1;
    stack[i * 3 + 0] = static_cast<int32_t>(n_c - 1);
    stack[i * 3 + 1] = t.a;
    stack[i * 3 + 2] = t.b;
  }
  return n_c;
}

// Flatten a batch of variable-size blocks into one buffer: the assembly
// fast path behind BCSRMatrix.from_blocks (reference: work-matrix merge in
// dbcsr_finalize, src/work/dbcsr_work_operations.F:749-958). Copies
// src[order[i]] (sizes[order[i]] doubles) consecutively into dst.
void dbcsr_flatten_f64(const double* const* src, const int64_t* sizes,
                       const int64_t* order, int64_t n, double* dst) {
  int64_t pos = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t b = order[i];
    std::memcpy(dst + pos, src[b], static_cast<size_t>(sizes[b]) * 8);
    pos += sizes[b];
  }
}

void dbcsr_flatten_f32(const float* const* src, const int64_t* sizes,
                       const int64_t* order, int64_t n, float* dst) {
  int64_t pos = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t b = order[i];
    std::memcpy(dst + pos, src[b], static_cast<size_t>(sizes[b]) * 4);
    pos += sizes[b];
  }
}

// Invert a scatter map: dst[map[i]] = i for i in [0, n), others = fill.
// (pack.inverse_map hot path: every multiply builds several of these.)
void dbcsr_inverse_map(const int64_t* map, int64_t n, int32_t* dst,
                       int64_t out_len, int32_t fill) {
  for (int64_t i = 0; i < out_len; ++i) dst[i] = fill;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t d = map[i];
    if (d >= 0 && d < out_len) dst[d] = static_cast<int32_t>(i);
  }
}

// Tile-store layout construction: the per-element flat→store map plus the
// occupied-tile inventory (block/store.py). One fused pass in C replaces
// several 10M-element numpy arithmetic passes on the host planner's hot
// path (the analog of the reference's Fortran index machinery,
// src/block/dbcsr_index_operations.F).
//
// Inputs:
//   nblks, blk_row[nblks], blk_col[nblks]      block coordinates (canonical)
//   row_off[nblkrows+1], col_off[nblkcols+1]   element offsets per block dim
//   blk_off[nblks+1]                           flat data offsets per block
//   tile, ntr, ntc                             tile edge + tile-grid extents
// Scratch (caller-allocated):
//   slot_of_tid[ntr*ntc] int64                 filled with slot or -1
// Outputs (caller-allocated):
//   elem_dest[nelems] int64                    flat element -> store position
//   tile_coords[2*max_tiles] int32             (trow, tcol) row-major order
// Returns n_tiles.
int64_t dbcsr_store_layout(int64_t nblks, const int64_t* blk_row,
                           const int64_t* blk_col, const int64_t* row_off,
                           const int64_t* col_off, const int64_t* blk_off,
                           int64_t tile, int64_t ntr, int64_t ntc,
                           int64_t* slot_of_tid, int64_t* elem_dest,
                           int32_t* tile_coords) {
  const int64_t ngrid = ntr * ntc;
  for (int64_t i = 0; i < ngrid; ++i) slot_of_tid[i] = 0;
  // pass 1: mark each block's touched tile rectangle
  for (int64_t b = 0; b < nblks; ++b) {
    const int64_t r0 = row_off[blk_row[b]], r1 = row_off[blk_row[b] + 1];
    const int64_t c0 = col_off[blk_col[b]], c1 = col_off[blk_col[b] + 1];
    if (r1 <= r0 || c1 <= c0) continue;
    const int64_t tr0 = r0 / tile, tr1 = (r1 - 1) / tile;
    const int64_t tc0 = c0 / tile, tc1 = (c1 - 1) / tile;
    for (int64_t tr = tr0; tr <= tr1; ++tr)
      for (int64_t tc = tc0; tc <= tc1; ++tc) slot_of_tid[tr * ntc + tc] = 1;
  }
  // slot assignment in row-major tile order
  int64_t n_tiles = 0;
  for (int64_t tid = 0; tid < ngrid; ++tid) {
    if (slot_of_tid[tid]) {
      tile_coords[2 * n_tiles] = static_cast<int32_t>(tid / ntc);
      tile_coords[2 * n_tiles + 1] = static_cast<int32_t>(tid % ntc);
      slot_of_tid[tid] = n_tiles++;
    } else {
      slot_of_tid[tid] = -1;
    }
  }
  // pass 2: per-element destinations (block-row-major element order).
  // Inner loops run division-free over tile-column segments; the common
  // power-of-two tile edge uses shift/mask.
  const int64_t tt = tile * tile;
  const bool pow2 = (tile & (tile - 1)) == 0;
  int shift = 0;
  while ((int64_t{1} << shift) < tile) ++shift;
  const int64_t mask = tile - 1;
  for (int64_t b = 0; b < nblks; ++b) {
    const int64_t r0 = row_off[blk_row[b]], r1 = row_off[blk_row[b] + 1];
    const int64_t c0 = col_off[blk_col[b]], c1 = col_off[blk_col[b] + 1];
    int64_t pos = blk_off[b];
    for (int64_t r = r0; r < r1; ++r) {
      const int64_t tr = pow2 ? (r >> shift) : (r / tile);
      const int64_t row_base = (pow2 ? (r & mask) : (r % tile)) * tile;
      const int64_t* row_slots = slot_of_tid + tr * ntc;
      int64_t c = c0;
      while (c < c1) {
        const int64_t tc = pow2 ? (c >> shift) : (c / tile);
        int64_t cend = (tc + 1) * tile;
        if (cend > c1) cend = c1;
        int64_t base =
            row_slots[tc] * tt + row_base + (pow2 ? (c & mask) : (c % tile));
        for (; c < cend; ++c) elem_dest[pos++] = base++;
      }
    }
  }
  return n_tiles;
}

}  // extern "C"
