"""Host-side CSR-of-blocks index: construction, canonicalization, merging.

Analog of the reference's index machinery
(``src/block/dbcsr_index_operations.F:54-69``; slot layout
``src/core/dbcsr_types.F:497-526``). The index lives on the host as numpy
arrays — index planning is branchy/latency-bound and belongs on CPU; only
flat block data lives on device (see ARCHITECTURE.md "host plans, device
executes").
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import scipy.sparse as sp

__all__ = [
    "BCSRIndex",
    "build_index",
    "merge_index",
    "convert_sizes_to_offsets",
    "convert_offsets_to_sizes",
]


def convert_sizes_to_offsets(sizes) -> np.ndarray:
    """Block sizes -> element offsets, length n+1
    (``dbcsr_convert_sizes_to_offsets``)."""
    return np.concatenate(
        [[0], np.cumsum(np.asarray(sizes, dtype=np.int64))]
    )


def convert_offsets_to_sizes(offsets) -> np.ndarray:
    """Element offsets (length n+1) -> block sizes
    (``dbcsr_convert_offsets_to_sizes``)."""
    return np.diff(np.asarray(offsets, dtype=np.int64)).astype(np.int32)


@dataclass(frozen=True)
class BCSRIndex:
    """Immutable block index.

    ``row_ptr``/``col_idx`` are canonical CSR over block coordinates
    (rows ascending, columns ascending within a row, no duplicates);
    ``blk_offset[b]`` is the element offset of block ``b`` in the flat data
    buffer, ``blk_offset[-1]`` the total element count.
    """

    row_block_sizes: np.ndarray  # int32 [nblkrows]
    col_block_sizes: np.ndarray  # int32 [nblkcols]
    row_ptr: np.ndarray  # int64 [nblkrows+1]
    col_idx: np.ndarray  # int32 [nnzb]
    blk_offset: np.ndarray  # int64 [nnzb+1]
    _cache: dict = field(default_factory=dict, compare=False, repr=False)

    # ------------------------------------------------------------------
    @property
    def nblkrows(self) -> int:
        return len(self.row_block_sizes)

    @property
    def nblkcols(self) -> int:
        return len(self.col_block_sizes)

    @property
    def nblks(self) -> int:
        return len(self.col_idx)

    @property
    def nelems(self) -> int:
        return int(self.blk_offset[-1])

    @property
    def nfullrows(self) -> int:
        return int(self.row_offsets[-1])

    @property
    def nfullcols(self) -> int:
        return int(self.col_offsets[-1])

    # ------------------------------------------------------------------
    def _cached(self, key, fn):
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key]

    @property
    def row_offsets(self) -> np.ndarray:
        """Element offset of each block-row in the dense matrix."""
        return self._cached(
            "row_offsets",
            lambda: np.concatenate(
                [[0], np.cumsum(self.row_block_sizes, dtype=np.int64)]
            ),
        )

    @property
    def col_offsets(self) -> np.ndarray:
        return self._cached(
            "col_offsets",
            lambda: np.concatenate(
                [[0], np.cumsum(self.col_block_sizes, dtype=np.int64)]
            ),
        )

    @property
    def blk_rows(self) -> np.ndarray:
        """Block-row id per stored block (expanded row_ptr), int32 [nnzb]."""
        return self._cached(
            "blk_rows",
            lambda: np.repeat(
                np.arange(self.nblkrows, dtype=np.int32),
                np.diff(self.row_ptr).astype(np.int64),
            ),
        )

    @property
    def blk_shapes(self) -> Tuple[np.ndarray, np.ndarray]:
        """(bm, bn) per block."""
        def mk():
            bm = self.row_block_sizes[self.blk_rows]
            bn = self.col_block_sizes[self.col_idx]
            return bm.astype(np.int32), bn.astype(np.int32)
        return self._cached("blk_shapes", mk)

    @property
    def elem_to_blk(self) -> np.ndarray:
        """Block id per flat data element, int32 [nelems]."""
        return self._cached(
            "elem_to_blk",
            lambda: np.repeat(
                np.arange(self.nblks, dtype=np.int32),
                np.diff(self.blk_offset).astype(np.int64),
            ),
        )

    def pattern(self) -> sp.csr_matrix:
        """Block-occupancy pattern as scipy CSR (values = block id + 1)."""
        def mk():
            return sp.csr_matrix(
                (
                    np.arange(1, self.nblks + 1, dtype=np.int64),
                    self.col_idx.astype(np.int64),
                    self.row_ptr.astype(np.int64),
                ),
                shape=(self.nblkrows, self.nblkcols),
            )
        return self._cached("pattern", mk)

    def block_id(self, row: int, col: int) -> int:
        """Binary-search lookup; -1 if the block is not stored."""
        lo, hi = int(self.row_ptr[row]), int(self.row_ptr[row + 1])
        pos = lo + np.searchsorted(self.col_idx[lo:hi], col)
        if pos < hi and self.col_idx[pos] == col:
            return int(pos)
        return -1

    def transposed(self) -> Tuple["BCSRIndex", np.ndarray]:
        """Index of the transpose + permutation mapping new block b' to the
        old block id it came from."""
        pat = self.pattern().tocsc()
        # CSC of A is CSR of A^T; values carry old block id + 1
        new_rows = np.repeat(
            np.arange(self.nblkcols, dtype=np.int32),
            np.diff(pat.indptr).astype(np.int64),
        )
        new_cols = pat.indices.astype(np.int32)
        perm = (pat.data - 1).astype(np.int64)
        bm, bn = self.blk_shapes
        sizes = (bm.astype(np.int64) * bn)[perm]
        blk_offset = np.concatenate([[0], np.cumsum(sizes)])
        idx = BCSRIndex(
            row_block_sizes=self.col_block_sizes,
            col_block_sizes=self.row_block_sizes,
            row_ptr=pat.indptr.astype(np.int64),
            col_idx=new_cols,
            blk_offset=blk_offset,
        )
        return idx, perm


def _canonical_order(rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    return np.lexsort((cols, rows))


def build_index(
    rows: np.ndarray,
    cols: np.ndarray,
    row_block_sizes: np.ndarray,
    col_block_sizes: np.ndarray,
) -> Tuple[BCSRIndex, np.ndarray]:
    """Build a canonical index from COO block coordinates.

    Returns (index, order) where ``order`` is the permutation that sorts the
    input coordinates into canonical CSR order (apply it to the caller's
    block list before flattening data). Duplicate coordinates are an error —
    accumulation of duplicates is the work-matrix layer's job
    (``src/work/dbcsr_work_operations.F:749-958``).
    """
    rows = np.asarray(rows, dtype=np.int32)
    cols = np.asarray(cols, dtype=np.int32)
    row_block_sizes = np.asarray(row_block_sizes, dtype=np.int32)
    col_block_sizes = np.asarray(col_block_sizes, dtype=np.int32)
    order = _canonical_order(rows, cols)
    r, c = rows[order], cols[order]
    if len(r) > 1 and np.any((r[1:] == r[:-1]) & (c[1:] == c[:-1])):
        raise ValueError("duplicate block coordinates; merge them first")
    nbr = len(row_block_sizes)
    counts = np.bincount(r, minlength=nbr).astype(np.int64)
    row_ptr = np.concatenate([[0], np.cumsum(counts)])
    sizes = row_block_sizes[r].astype(np.int64) * col_block_sizes[c]
    blk_offset = np.concatenate([[0], np.cumsum(sizes)])
    idx = BCSRIndex(
        row_block_sizes=row_block_sizes,
        col_block_sizes=col_block_sizes,
        row_ptr=row_ptr,
        col_idx=c,
        blk_offset=blk_offset,
    )
    return idx, order


def merge_index(
    a: BCSRIndex, b: BCSRIndex
) -> Tuple[BCSRIndex, np.ndarray, np.ndarray]:
    """Union of two indices over the same block structure.

    Returns (merged, a_to_merged, b_to_merged) with block-id maps into the
    merged index. This is the host-side analog of the reference's index-merge
    add (``dbcsr_add``, ``src/ops/dbcsr_operations.F``).
    """
    if len(a.row_block_sizes) != len(b.row_block_sizes) or len(
        a.col_block_sizes
    ) != len(b.col_block_sizes):
        raise ValueError("incompatible block structures")
    pa = a.pattern().astype(bool)
    pb = b.pattern().astype(bool)
    pm = (pa + pb).tocsr()
    pm.sort_indices()
    rows = np.repeat(
        np.arange(pm.shape[0], dtype=np.int32), np.diff(pm.indptr).astype(np.int64)
    )
    cols = pm.indices.astype(np.int32)
    merged, order = build_index(rows, cols, a.row_block_sizes, a.col_block_sizes)
    # locate a's and b's blocks inside merged (both canonical → searchsorted)
    key_m = rows.astype(np.int64)[order] * merged.nblkcols + cols.astype(np.int64)[order]
    for_a = a.blk_rows.astype(np.int64) * merged.nblkcols + a.col_idx
    for_b = b.blk_rows.astype(np.int64) * merged.nblkcols + b.col_idx
    a_to_m = np.searchsorted(key_m, for_a)
    b_to_m = np.searchsorted(key_m, for_b)
    return merged, a_to_m.astype(np.int64), b_to_m.astype(np.int64)
