"""TAS matrix type + block-subset extraction/merge utilities.

Analog of ``dbcsr_tas_type`` (``src/tas/dbcsr_tas_types.F:78-100``): a TAS
matrix wraps an ordinary BCSR matrix plus split info for its long dimension.
The reference additionally carries int8 global distributions as function
objects so huge index arrays never materialize; at Python/numpy block
granularity the group map is cheap, so it IS materialized (int32 per block
of the long dimension only).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..block.bcsr import BCSRMatrix, SYM_NONE
from ..block.index import build_index
from ..core.errors import dbcsr_assert
from .split import COLSPLIT, ROWSPLIT, TASSplit

__all__ = ["TASMatrix", "tas_from_matrix", "extract_block_subset", "merge_row_groups"]


@dataclass(frozen=True)
class TASMatrix:
    """A BCSR matrix + split of its long dimension."""

    matrix: BCSRMatrix
    split: TASSplit

    def __post_init__(self):
        nblk = (
            self.matrix.nblkrows
            if self.split.rowcol == ROWSPLIT
            else self.matrix.nblkcols
        )
        dbcsr_assert(
            self.split.nblk_long == nblk,
            "split length does not match the split dimension",
        )

    @property
    def nsplit(self) -> int:
        return self.split.nsplit

    @property
    def name(self) -> str:
        return self.matrix.name

    @property
    def shape(self) -> Tuple[int, int]:
        return self.matrix.shape

    def group_matrix(self, g: int) -> Tuple[BCSRMatrix, np.ndarray]:
        """The compacted submatrix of group ``g`` plus the global block ids
        of its (compacted) long dimension — the analog of the reference's
        per-subgroup local matrix (``dbcsr_tas_split.F`` subgroup views)."""
        blocks = self.split.blocks_of_group(g)
        if self.split.rowcol == ROWSPLIT:
            sub = extract_block_subset(self.matrix, row_blocks=blocks)
        else:
            sub = extract_block_subset(self.matrix, col_blocks=blocks)
        return sub, blocks

    def with_split(self, split: TASSplit) -> "TASMatrix":
        """Change the split layout (``dbcsr_tas_reshape`` analog,
        ``src/tas/dbcsr_tas_reshape_ops.F:95``). Locally this is metadata —
        group extraction picks different blocks; on a distributed mesh the
        executor reshards (all_to_all) when packing group panels."""
        return replace(self, split=split)


def tas_from_matrix(
    m: BCSRMatrix,
    *,
    rowcol: Optional[str] = None,
    nsplit: int = 1,
    split: Optional[TASSplit] = None,
) -> TASMatrix:
    """Wrap a matrix as TAS. With no explicit split, the longer block
    dimension is chosen and split cyclically."""
    if split is None:
        if rowcol is None:
            rowcol = ROWSPLIT if m.nblkrows >= m.nblkcols else COLSPLIT
        nblk = m.nblkrows if rowcol == ROWSPLIT else m.nblkcols
        split = TASSplit.cyclic(rowcol, nblk, nsplit)
    return TASMatrix(matrix=m, split=split)


def extract_block_subset(
    m: BCSRMatrix,
    *,
    row_blocks: Optional[np.ndarray] = None,
    col_blocks: Optional[np.ndarray] = None,
) -> BCSRMatrix:
    """Compacted submatrix over a subset of block rows and/or columns.

    The new matrix's block dimensions are the subsets themselves (global
    block ``row_blocks[i]`` becomes block row ``i``). One host index rebuild
    plus one device gather — this library's form of the reference's subgroup
    matrix extraction inside TAS reshape (``dbcsr_tas_reshape_ops.F``).
    """
    if m.is_complex_emulated:
        from ..ops.complex_emu import map_parts

        return map_parts(
            m,
            lambda x: extract_block_subset(
                x, row_blocks=row_blocks, col_blocks=col_blocks
            ),
        )
    dbcsr_assert(m.sym == SYM_NONE, "desymmetrize before subset extraction")
    idx = m.index
    rows_sel = (
        np.arange(idx.nblkrows, dtype=np.int32)
        if row_blocks is None
        else np.asarray(row_blocks, dtype=np.int32)
    )
    cols_sel = (
        np.arange(idx.nblkcols, dtype=np.int32)
        if col_blocks is None
        else np.asarray(col_blocks, dtype=np.int32)
    )
    # old -> new block-row/col id (-1 = dropped)
    rmap = np.full(idx.nblkrows, -1, dtype=np.int64)
    rmap[rows_sel] = np.arange(len(rows_sel))
    cmap = np.full(idx.nblkcols, -1, dtype=np.int64)
    cmap[cols_sel] = np.arange(len(cols_sel))
    old_rows = idx.blk_rows
    old_cols = idx.col_idx
    keep = (rmap[old_rows] >= 0) & (cmap[old_cols] >= 0)
    kept = np.flatnonzero(keep)
    new_index, order = build_index(
        rmap[old_rows[kept]],
        cmap[old_cols[kept]],
        idx.row_block_sizes[rows_sel],
        idx.col_block_sizes[cols_sel],
    )
    src_blks = kept[order].astype(np.int64)
    # flat-layout gather map (blocks are contiguous runs), composed with the
    # tile-store layouts and applied as one device gather
    from ..block.gather import apply_flat_gather, block_permutation_gather

    if new_index.nblks:
        gmap = block_permutation_gather(new_index, idx, src_blks)
        data = apply_flat_gather(new_index, m.tile, m, gmap)
    else:
        data = jnp.zeros((0, m.tile, m.tile), dtype=m.dtype)
    return BCSRMatrix(
        name=m.name, index=new_index, data=data, sym=SYM_NONE, dist=None
    )


def merge_row_groups(
    parts: List[Tuple[BCSRMatrix, np.ndarray]],
    row_block_sizes: np.ndarray,
    col_block_sizes: np.ndarray,
    *,
    name: str = "merged",
    dtype=None,
) -> BCSRMatrix:
    """Assemble a full matrix from disjoint row-group submatrices.

    ``parts`` — (submatrix, global row-block ids of its rows). The inverse
    of per-group extraction; analog of ``dbcsr_tas_merge``
    (``src/tas/dbcsr_tas_mm.F:477``) for the row-split case.
    """
    return _merge_groups(
        parts, row_block_sizes, col_block_sizes, map_rows=True, name=name,
        dtype=dtype,
    )


def merge_col_groups(
    parts: List[Tuple[BCSRMatrix, np.ndarray]],
    row_block_sizes: np.ndarray,
    col_block_sizes: np.ndarray,
    *,
    name: str = "merged",
    dtype=None,
) -> BCSRMatrix:
    """Assemble a full matrix from disjoint column-group submatrices
    (``parts`` carry global col-block ids) — the colsplit twin of
    :func:`merge_row_groups` (``dbcsr_tas_merge`` handles both via the
    split's rowcol flag, ``src/tas/dbcsr_tas_split.F:60``)."""
    return _merge_groups(
        parts, row_block_sizes, col_block_sizes, map_rows=False, name=name,
        dtype=dtype,
    )


def _merge_groups(
    parts: List[Tuple[BCSRMatrix, np.ndarray]],
    row_block_sizes: np.ndarray,
    col_block_sizes: np.ndarray,
    *,
    map_rows: bool,
    name: str,
    dtype=None,
) -> BCSRMatrix:
    from ..block.gather import apply_flat_gather

    if any(sub.is_complex_emulated for sub, _ in parts):
        from ..block.bcsr import BCSRMatrix as _M
        from ..ops.complex_emu import lift

        cdtype = np.result_type(*(sub.dtype for sub, _ in parts))
        res = [
            (lift(sub, cdtype).parts(), blocks) for sub, blocks in parts
        ]
        rr = _merge_groups(
            [(pr[0], blk) for pr, blk in res], row_block_sizes,
            col_block_sizes, map_rows=map_rows, name=name,
        )
        ii = _merge_groups(
            [(pr[1], blk) for pr, blk in res], row_block_sizes,
            col_block_sizes, map_rows=map_rows, name=name,
        )
        return _M.combine(rr, ii, cdtype, name=name, sym=rr.sym)

    rows_all: List[np.ndarray] = []
    cols_all: List[np.ndarray] = []
    part_of_blk: List[np.ndarray] = []
    offsets = []
    for p, (sub, blocks_of) in enumerate(parts):
        bmap = np.asarray(blocks_of, dtype=np.int64)
        if map_rows:
            rows_all.append(bmap[sub.index.blk_rows].astype(np.int32))
            cols_all.append(sub.index.col_idx)
        else:
            rows_all.append(sub.index.blk_rows)
            cols_all.append(bmap[sub.index.col_idx].astype(np.int32))
        part_of_blk.append(np.full(sub.nblks, p, dtype=np.int32))
        offsets.append(sub.index.blk_offset[:-1])
    nnz = sum(len(r) for r in rows_all)
    if not rows_all or nnz == 0:
        return BCSRMatrix.empty(
            row_block_sizes, col_block_sizes, name=name,
            dtype=dtype or (parts[0][0].dtype if parts else np.float32),
        )
    rows = np.concatenate(rows_all)
    cols = np.concatenate(cols_all)
    part_ids = np.concatenate(part_of_blk)
    blk_src_off = np.concatenate(offsets)
    new_index, order = build_index(rows, cols, row_block_sizes, col_block_sizes)
    # per-part flat gather maps into the merged matrix; block row groups are
    # disjoint, so the merged store is the SUM of the per-part stores
    b = new_index.elem_to_blk.astype(np.int64)
    t = np.arange(new_index.nelems, dtype=np.int64) - new_index.blk_offset[b]
    src_flat = blk_src_off[order][b] + t
    src_part = part_ids[order][b]
    tile = parts[0][0].tile
    data = None
    for p, (sub, _) in enumerate(parts):
        fmap = np.where(src_part == p, src_flat, -1)
        contrib = apply_flat_gather(new_index, tile, sub, fmap)
        data = contrib if data is None else data + contrib
    return BCSRMatrix(
        name=name, index=new_index, data=data, sym=SYM_NONE, dist=None
    )
