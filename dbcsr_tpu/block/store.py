"""Tile-store layout: the at-rest device representation of a matrix.

Element-level gathers with arbitrary indices move one scalar per index,
while tile-level (whole [T,T]) and row-level gathers move contiguous
slabs at memory bandwidth (ARCHITECTURE.md "gather granularity").
Everything the device touches per multiply therefore moves at tile
granularity.

Consequence: a matrix's device data IS its own T×T tile store — a
``[n_tiles, T, T]`` array holding the dense content of every tile that
overlaps at least one stored block, zero elsewhere (the invariant every op
must preserve: padding positions are exactly 0). The multiply engine then
needs NO packing for 'N' orientation (the store is the panel), transposed
orientation costs one tile permutation + vectorized per-tile transpose, and
the result is produced directly in C's store layout.

The element-granular flat layout (blocks contiguous, the reference's
``data_area``) survives HOST-side only, as the interchange format for
assembly, I/O, CSR conversion and block access; ``StoreLayout.elem_dest``
converts between the two with numpy (C-speed) on the host.

Block-granular semantics on device (norms, filtering masks, row/col
scaling) run through per-tile INDICATOR matmuls built here: all tiles in
tile-row ``tr`` share the row→block-row indicator ``J[tr] ∈ {0,1}^{T×Amax}``
and all tiles in tile-col ``tc`` share ``I[tc] ∈ {0,1}^{T×Bmax}``, so
per-block sums are two small batched matmuls (matrix-unit work, no
scatters):
``z[t] = J[tr(t)]ᵀ (x∘x)[t] I[tc(t)]``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .index import BCSRIndex

__all__ = ["StoreLayout", "store_layout", "RowIndicators", "row_indicators"]


@dataclass(frozen=True)
class StoreLayout:
    """Tile layout of one matrix index at tile edge ``tile``."""

    tile: int
    ntr: int  # tile rows of the full matrix
    ntc: int  # tile cols
    tile_coords: np.ndarray  # int32 [n_tiles, 2] (trow, tcol), row-major order
    elem_dest: np.ndarray  # int64 [nelems_flat] flat-block elem -> store pos
    tile_of_rc: dict  # (trow, tcol) -> slot  (host lookups)

    @property
    def n_tiles(self) -> int:
        return len(self.tile_coords)

    def tile_keys(self) -> np.ndarray:
        """Row-major tile ids (sorted, since tile_coords is row-major)."""
        return (
            self.tile_coords[:, 0].astype(np.int64) * self.ntc
            + self.tile_coords[:, 1]
        )

    # -- host flat <-> store conversion ------------------------------------
    def store_from_flat(self, flat: np.ndarray) -> np.ndarray:
        """numpy scatter: flat block data -> [n_tiles, T, T] store."""
        if self.n_tiles == 0:
            return np.zeros((0, self.tile, self.tile), dtype=flat.dtype)
        out = np.zeros((self.n_tiles * self.tile * self.tile,), dtype=flat.dtype)
        out[self.elem_dest] = flat
        return out.reshape(self.n_tiles, self.tile, self.tile)

    def flat_from_store(self, store: np.ndarray) -> np.ndarray:
        """numpy gather: store -> flat block data."""
        return np.asarray(store).reshape(-1)[self.elem_dest]


def store_layout(index: BCSRIndex, tile: int) -> StoreLayout:
    """Cached tile layout of ``index`` (orientation N)."""
    key = ("store_layout", tile)

    def mk():
        from ..core.config import get_config

        nat = None
        if get_config().use_native_planner:
            from ..native import store_layout_native

            nat = store_layout_native(index, tile)
        if nat is not None:
            tile_coords, elem_dest, ntr, ntc = nat
        else:
            from ..mm.pack import tile_panel_maps

            elem_dest, tile_coords, (ntr, ntc) = tile_panel_maps(
                index, tile, False
            )
            elem_dest = elem_dest.astype(np.int64)
        lut = {
            (int(r), int(c)): i
            for i, (r, c) in enumerate(np.asarray(tile_coords))
        }
        return StoreLayout(
            tile=tile,
            ntr=ntr,
            ntc=ntc,
            tile_coords=tile_coords,
            elem_dest=elem_dest,
            tile_of_rc=lut,
        )

    return index._cached(key, mk)


@dataclass(frozen=True)
class RowIndicators:
    """Row→block indicator tables for one dimension's block sizes.

    ``J`` — float32 [n_tile_rows, T, seg_max]: ``J[tr, i, a] = 1`` iff
    global row ``tr·T + i`` belongs to the ``a``-th block-row intersecting
    tile-row ``tr`` (0 for padding rows/segments).
    ``block_of_seg`` — int32 [n_tile_rows, seg_max]: global block-row id per
    segment (-1 padding).
    """

    J: np.ndarray
    block_of_seg: np.ndarray

    @property
    def seg_max(self) -> int:
        return self.J.shape[2]


def row_indicators(
    block_sizes: np.ndarray, tile: int, index: Optional[BCSRIndex] = None,
    cache_key: str = "row",
) -> RowIndicators:
    """Build (and cache on ``index``) the indicator tables for one
    dimension."""
    def mk():
        sizes = np.asarray(block_sizes, dtype=np.int64)
        off = np.concatenate([[0], np.cumsum(sizes)])
        total = int(off[-1])
        ntr = -(-total // tile)
        blk_of_row = np.repeat(np.arange(len(sizes), dtype=np.int64), sizes)
        blk_of_row = np.concatenate(
            [blk_of_row, np.full(ntr * tile - total, -1, dtype=np.int64)]
        ).reshape(ntr, tile)
        seg_max = 1
        segs = []
        for tr in range(ntr):
            u = np.unique(blk_of_row[tr])
            u = u[u >= 0]
            segs.append(u)
            seg_max = max(seg_max, len(u))
        J = np.zeros((ntr, tile, seg_max), dtype=np.float32)
        block_of_seg = np.full((ntr, seg_max), -1, dtype=np.int32)
        for tr, u in enumerate(segs):
            block_of_seg[tr, : len(u)] = u
            pos = np.searchsorted(u, blk_of_row[tr])
            valid = blk_of_row[tr] >= 0
            J[tr, np.arange(tile)[valid], pos[valid]] = 1.0
        return RowIndicators(J=J, block_of_seg=block_of_seg)

    if index is not None:
        return index._cached(("row_indicators", cache_key, tile), mk)
    return mk()
