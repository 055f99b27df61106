"""Tile-granular device operations on tile stores.

Every per-multiply device operation must move data at tile (or >=128-lane
row) granularity — element-granular gathers are far slower (see
``store.py``). This module provides the shared primitives:

- store alignment (union/intersection/re-keying) via tile-level ``take``;
- coordinate masks (triu / strict-lower / element-range crop) computed on
  device by broadcasting over each tile's global coordinates;
- the block↔tile indicator machinery: per-tile block-segment indicators
  turn block-granular semantics (per-block norms, block keep/drop masks,
  validity masks) into small batched matmuls — matrix-unit work instead
  of scatters. This replaces the reference's element loops in
  ``dbcsr_block_operations.F`` and the norms kernels
  (``src/acc/cuda_hip/calculate_norms.cpp``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .index import BCSRIndex
from .store import StoreLayout, row_indicators, store_layout

__all__ = [
    "tile_align_map",
    "take_tiles",
    "coord_mask",
    "TileBlockInfo",
    "tile_block_info",
    "block_sums_sq",
    "block_mask_store",
    "valid_mask",
    "transpose_store",
]


# ---------------------------------------------------------------------------
# store alignment
# ---------------------------------------------------------------------------

def tile_align_map(dst_keys: np.ndarray, src_keys: np.ndarray) -> np.ndarray:
    """For each destination tile key, the source slot holding it (or -1).
    Both key arrays must be sorted (row-major tile ids are)."""
    pos = np.searchsorted(src_keys, dst_keys)
    pos_c = np.minimum(pos, max(len(src_keys) - 1, 0))
    hit = (
        (src_keys[pos_c] == dst_keys)
        if len(src_keys)
        else np.zeros(len(dst_keys), dtype=bool)
    )
    return np.where(hit, pos_c, -1).astype(np.int32)


def take_tiles(store: jax.Array, slot_map: np.ndarray, tile: int) -> jax.Array:
    """Tile-level gather: out[i] = store[slot_map[i]] (zero tile for -1).

    Negative sentinels are remapped to a positive out-of-bounds value first:
    jnp's fill mode wraps -1 Python-style instead of filling."""
    if len(slot_map) == 0 or store.shape[0] == 0:
        return jnp.zeros((len(slot_map), tile, tile), dtype=store.dtype)
    slot_map = np.asarray(slot_map)
    if len(slot_map) == store.shape[0] and np.array_equal(
        slot_map, np.arange(len(slot_map))
    ):
        return store  # identity alignment: no copy
    oob = np.where(slot_map < 0, np.iinfo(np.int32).max, slot_map).astype(
        np.int32
    )
    return jnp.take(store, jnp.asarray(oob), axis=0, mode="fill", fill_value=0)


# ---------------------------------------------------------------------------
# coordinate masks (device, broadcast from tile coords — no element maps)
# ---------------------------------------------------------------------------

def coord_mask(
    layout: StoreLayout,
    fn: Callable[[jax.Array, jax.Array], jax.Array],
) -> jax.Array:
    """Boolean [n_tiles, T, T] mask: ``fn(global_row, global_col)`` applied
    per tile via broadcasting (e.g. triu: ``lambda r, c: r <= c``)."""
    t = layout.tile
    coords = jnp.asarray(layout.tile_coords.astype(np.int64))
    r = coords[:, 0, None, None] * t + jnp.arange(t)[None, :, None]
    c = coords[:, 1, None, None] * t + jnp.arange(t)[None, None, :]
    return fn(r, c)


# ---------------------------------------------------------------------------
# block <-> tile indicator machinery
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TileBlockInfo:
    """Per-tile block-segment structure of one index at tile edge T.

    ``amax``/``bmax`` — max block-row/col segments intersecting any tile
    row/col; ``J`` [ntr, T, amax] / ``I`` [ntc, T, bmax] — row/col→segment
    indicators shared along tile rows/cols; ``K`` [n_tiles, amax, bmax] —
    1 where the (segment-row, segment-col) pair is a STORED block of this
    tile; ``bid`` — the stored block id there (-1 otherwise); ``J_dev`` /
    ``I_dev`` — per-tile device indicator stacks (tile-level take of J/I).
    """

    amax: int
    bmax: int
    J: np.ndarray
    I: np.ndarray
    K: np.ndarray
    bid: np.ndarray
    J_dev: jax.Array  # [n_tiles, T, amax]
    I_dev: jax.Array  # [n_tiles, T, bmax]


def tile_block_info(index: BCSRIndex, tile: int) -> TileBlockInfo:
    """Cached per-(index, tile) block/tile structure."""
    key = ("tile_block_info", tile)

    def mk():
        lay = store_layout(index, tile)
        rind = row_indicators(index.row_block_sizes, tile, index, "rows")
        cind = row_indicators(index.col_block_sizes, tile, index, "cols")
        amax, bmax = rind.seg_max, cind.seg_max
        nt = lay.n_tiles
        K = np.zeros((nt, amax, bmax), dtype=np.float32)
        bid = np.full((nt, amax, bmax), -1, dtype=np.int64)
        if nt:
            # (block, tile) pairs: blocks span <= few tiles each
            ro = index.row_offsets
            co = index.col_offsets
            br = index.blk_rows.astype(np.int64)
            bc = index.col_idx.astype(np.int64)
            r0, r1 = ro[br], ro[br + 1]
            c0, c1 = co[bc], co[bc + 1]
            tr0, tr1 = r0 // tile, (r1 - 1) // tile
            tc0, tc1 = c0 // tile, (c1 - 1) // tile
            nr = (tr1 - tr0 + 1).astype(np.int64)
            nc = (tc1 - tc0 + 1).astype(np.int64)
            counts = nr * nc
            total = int(counts.sum())
            b_of = np.repeat(np.arange(index.nblks, dtype=np.int64), counts)
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            t_local = np.arange(total, dtype=np.int64) - starts[b_of]
            tr = tr0[b_of] + t_local // nc[b_of]
            tc = tc0[b_of] + t_local % nc[b_of]
            # tile slot lookup: row-major sorted keys -> searchsorted
            all_keys = lay.tile_keys()
            slot = np.searchsorted(all_keys, tr * lay.ntc + tc)
            # segment position: the block rows/cols intersecting one tile
            # row/col are CONSECUTIVE ids, so the position is just the
            # offset from the first block of that tile row/col
            A = br[b_of] - rind.block_of_seg[tr, 0]
            B = bc[b_of] - cind.block_of_seg[tc, 0]
            K[slot, A, B] = 1.0
            bid[slot, A, B] = b_of
        J_dev = jnp.asarray(rind.J[lay.tile_coords[:, 0]]) if nt else jnp.zeros(
            (0, tile, amax), np.float32
        )
        I_dev = jnp.asarray(cind.J[lay.tile_coords[:, 1]]) if nt else jnp.zeros(
            (0, tile, bmax), np.float32
        )
        return TileBlockInfo(
            amax=amax, bmax=bmax, J=rind.J, I=cind.J, K=K, bid=bid,
            J_dev=J_dev, I_dev=I_dev,
        )

    return index._cached(key, mk)


@jax.jit
def _per_tile_block_sums(store, J_dev, I_dev):
    """z[t, a, b] = sum_{i,j} J[t,i,a] * |x[t,i,j]|^2 * I[t,j,b].

    HIGHEST precision: norms are true single precision like the
    reference's (``calculate_norms.cpp``); a default-precision pass (TF32
    on the GPU) would quantize them to ~3 digits."""
    x2 = (store * jnp.conj(store)).real.astype(jnp.float32)
    y = jnp.einsum(
        "tia,tij->taj", J_dev, x2, precision=jax.lax.Precision.HIGHEST
    )
    return jnp.einsum(
        "taj,tjb->tab", y, I_dev, precision=jax.lax.Precision.HIGHEST
    )


def block_sums_sq(index: BCSRIndex, tile: int, store: jax.Array) -> np.ndarray:
    """Per-block Frobenius-norm² (float32 like the reference's norms,
    ``src/mm/dbcsr_mm_common.F:629-694``): two batched indicator matmuls on
    device, small combine on host."""
    info = tile_block_info(index, tile)
    if index.nblks == 0:
        return np.zeros(0, dtype=np.float32)
    z = np.asarray(_per_tile_block_sums(store, info.J_dev, info.I_dev))
    out = np.zeros(index.nblks + 1, dtype=np.float64)
    np.add.at(out, info.bid.reshape(-1) + 1, z.reshape(-1))
    return out[1:].astype(np.float32)


@jax.jit
def _mask_matmul(J_dev, Kd, I_dev):
    """mask[t,i,j] = sum_ab J[t,i,a] K[t,a,b] I[t,j,b]  (0/1-valued)."""
    return jnp.einsum("tia,tab,tjb->tij", J_dev, Kd, I_dev)


def block_mask_store(
    index: BCSRIndex,
    tile: int,
    keep: Optional[np.ndarray] = None,
    dtype=jnp.float32,
) -> jax.Array:
    """[n_tiles, T, T] mask with 1 at positions of kept stored blocks.

    ``keep=None`` keeps every stored block — the store-validity mask (1 on
    block-covered positions, 0 on padding)."""
    info = tile_block_info(index, tile)
    if keep is None:
        Kd = jnp.asarray(info.K)
    else:
        kf = np.zeros(index.nblks + 1, dtype=np.float32)
        kf[1:] = np.asarray(keep, dtype=np.float32)
        Kd = jnp.asarray(kf[info.bid + 1] * info.K)
    return _mask_matmul(info.J_dev, Kd, info.I_dev).astype(dtype)


def valid_mask(index: BCSRIndex, tile: int) -> jax.Array:
    """Cached validity mask (1 where a stored block covers the position)."""
    key = ("valid_mask", tile)
    return index._cached(
        key, lambda: block_mask_store(index, tile, None)
    )


# ---------------------------------------------------------------------------
# transposed store
# ---------------------------------------------------------------------------

def transpose_store(
    m_index: BCSRIndex, tile: int, store: jax.Array, conj: bool = False
) -> Tuple[jax.Array, np.ndarray]:
    """The tile store of the TRANSPOSED matrix: tile (r,c) → (c,r) permuted
    (tile-level take, fast) + vectorized per-tile transpose.

    Returns (store_T, tile_coords_T) where ``tile_coords_T`` is row-major
    over the transposed tile grid.
    """
    lay = store_layout(m_index, tile)
    coords = lay.tile_coords
    # transposed tile keys: (c, r) row-major over [ntc, ntr]
    keys_t = coords[:, 1].astype(np.int64) * lay.ntr + coords[:, 0]
    order = np.argsort(keys_t)
    out = jnp.take(store, jnp.asarray(order.astype(np.int32)), axis=0)
    out = jnp.swapaxes(out, 1, 2)
    if conj:
        out = jnp.conj(out)
    coords_t = np.stack(
        [coords[order, 1], coords[order, 0]], axis=1
    ).astype(np.int32)
    return out, coords_t
