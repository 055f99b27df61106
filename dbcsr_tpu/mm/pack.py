"""Host-built scatter/gather maps between flat block data and panels.

This is the heart of the two-level layout (ARCHITECTURE.md): a matrix "at
rest" is flat block data; "in motion" it is a hardware-tiled panel. The maps
are plain int32 index arrays built once per (index, tile, transpose) on the
host and cached on the index object; applying one is a single XLA
scatter/gather that runs at HBM bandwidth. ``op(A)='T'`` folds into the map
— the reference's GPU transpose kernel (``smm_acc_transpose.h``) has no
equivalent here.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..block.index import BCSRIndex

__all__ = [
    "elem_coords",
    "dense_scatter_map",
    "panel_scatter_map",
    "tile_panel_maps",
]


def elem_coords(index: BCSRIndex) -> Tuple[np.ndarray, np.ndarray]:
    """Global (row, col) element coordinates of every flat data element,
    int64 each, cached."""
    def mk():
        b = index.elem_to_blk.astype(np.int64)
        t = np.arange(index.nelems, dtype=np.int64) - index.blk_offset[b]
        bn = index.col_block_sizes[index.col_idx].astype(np.int64)[b]
        r_in = t // bn
        c_in = t - r_in * bn
        rows = index.row_offsets[index.blk_rows[b]] + r_in
        cols = index.col_offsets[index.col_idx[b]] + c_in
        return rows, cols

    return index._cached("elem_coords", mk)


def dense_scatter_map(index: BCSRIndex) -> np.ndarray:
    """Destination of each flat element in the row-major dense matrix."""
    def mk():
        rows, cols = elem_coords(index)
        return (rows * index.nfullcols + cols).astype(np.int64)

    return index._cached("dense_scatter_map", mk)


def _padded(n: int, t: int) -> int:
    return -(-n // t) * t


def panel_scatter_map(
    index: BCSRIndex, tile: int, transpose: bool
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Scatter map into a zero-padded dense panel aligned to ``tile``.

    Returns (dest int32 [nelems], (Mp, Np)); with ``transpose`` the panel
    holds op(A)=A^T and the map swaps coordinates, so transposition costs
    nothing beyond the scatter that packing pays anyway.
    """
    key = ("panel_scatter", tile, transpose)

    def mk():
        rows, cols = elem_coords(index)
        if transpose:
            rows, cols = cols, rows
            mp = _padded(index.nfullcols, tile)
            np_ = _padded(index.nfullrows, tile)
        else:
            mp = _padded(index.nfullrows, tile)
            np_ = _padded(index.nfullcols, tile)
        dest = rows * np_ + cols
        if dest.size and int(dest.max()) >= np.iinfo(np.int32).max:
            raise OverflowError("panel too large for int32 scatter map")
        return dest.astype(np.int32), (mp, np_)

    return index._cached(key, mk)


def tile_panel_maps(
    index: BCSRIndex, tile: int, transpose: bool
) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
    """Maps for the tile-sparse panel layout ``[n_tiles, tile, tile]``.

    Returns (dest int32 [nelems] into the flattened tile store,
    tile_coords int32 [n_tiles, 2] = (tile_row, tile_col) per stored tile,
    (tile_rows_total, tile_cols_total)).

    Only tiles overlapped by at least one stored element exist; the tile
    grid is the panel's T×T partition of op(A)'s shape.
    """
    key = ("tile_panel", tile, transpose)

    def mk():
        rows, cols = elem_coords(index)
        if transpose:
            rows, cols = cols, rows
            nrow, ncol = index.nfullcols, index.nfullrows
        else:
            nrow, ncol = index.nfullrows, index.nfullcols
        ntr = -(-nrow // tile)
        ntc = -(-ncol // tile)
        trow = rows // tile
        tcol = cols // tile
        tid = trow * ntc + tcol
        uniq, slot_of_elem = np.unique(tid, return_inverse=True)
        tile_coords = np.stack(
            [(uniq // ntc).astype(np.int32), (uniq % ntc).astype(np.int32)],
            axis=1,
        )
        dest = (
            slot_of_elem.astype(np.int64) * (tile * tile)
            + (rows - trow * tile) * tile
            + (cols - tcol * tile)
        )
        if dest.size and int(dest.max()) >= np.iinfo(np.int32).max:
            raise OverflowError("tile panel too large for int32 scatter map")
        return dest.astype(np.int32), tile_coords, (ntr, ntc)

    return index._cached(key, mk)


_I32_OOB = np.iinfo(np.int32).max


def inverse_map(dest: np.ndarray, total: int) -> np.ndarray:
    """Invert a scatter map into a gather map.

    Scatters with arbitrary indices serialize badly; gathers are fast.
    Every pack therefore runs as ``data.at[inv].get(mode='fill')`` where
    ``inv[pos]`` is the source element of panel position ``pos`` (holes get
    an out-of-range marker that gathers as 0).
    """
    inv = np.full(total, _I32_OOB, dtype=np.int32)
    inv[dest] = np.arange(len(dest), dtype=np.int32)
    return inv


def panel_gather_map(index: "BCSRIndex", tile: int, transpose: bool):
    """Inverse (gather) form of ``panel_scatter_map``, cached."""
    key = ("panel_gather", tile, transpose)

    def mk():
        dest, (mp, np_) = panel_scatter_map(index, tile, transpose)
        return inverse_map(dest, mp * np_), (mp, np_)

    return index._cached(key, mk)
