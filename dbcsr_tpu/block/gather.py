"""Element-level gather maps for block permutation / transposition.

Used by transpose, desymmetrize, redistribute and filtering: every such
transformation is (new index built on host) + (one device gather through a
host-built int32 map). This replaces the reference's block-by-block copy /
transpose loops (``src/block/dbcsr_block_operations.F``) with single
bandwidth-bound XLA ops.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np

from .index import BCSRIndex

__all__ = [
    "block_permutation_gather",
    "block_subset_gather",
    "apply_flat_gather",
]


def block_permutation_gather(
    new_index: BCSRIndex,
    src_index: BCSRIndex,
    src_blk_of_new: np.ndarray,
    transpose_src: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Gather map (int64 [new nelems]) pulling each element of the new
    layout from the source flat buffer.

    ``src_blk_of_new[b]`` is the source block id for new block ``b``;
    ``transpose_src[b]`` marks blocks whose source is stored transposed
    (new block = src block **T**).
    """
    if new_index.nblks == 0:
        return np.zeros((0,), dtype=np.int64)
    b = new_index.elem_to_blk.astype(np.int64)
    t = np.arange(new_index.nelems, dtype=np.int64) - new_index.blk_offset[b]
    bm_new, bn_new = new_index.blk_shapes
    bn = bn_new.astype(np.int64)[b]
    r = t // bn
    c = t - r * bn
    src_blk = src_blk_of_new.astype(np.int64)[b]
    base = src_index.blk_offset[src_blk]
    if transpose_src is None:
        return base + t
    tr = transpose_src[b]
    # source stored (bn_new, bm_new) row-major when transposed
    bm = bm_new.astype(np.int64)[b]
    straight = r * bn + c
    flipped = c * bm + r
    return base + np.where(tr, flipped, straight)


def block_subset_gather(index: BCSRIndex, keep_mask: np.ndarray) -> np.ndarray:
    """Element indices (int64) of the blocks kept by ``keep_mask``, in
    canonical order — the data-compaction map for filtering."""
    keep_elem = keep_mask[index.elem_to_blk]
    return np.flatnonzero(keep_elem).astype(np.int64)


def flat_gather_store_map(
    new_index, tile, src_layout, src_flat_of_new: np.ndarray
) -> np.ndarray:
    """Host half of the flat gather: compose the flat-element map with
    both tile-store layouts into one store-position gather map (int64
    [new n_tiles * tile * tile], out-of-range = gather 0). Pure content —
    cacheable by callers that repeat the same transformation."""
    from .store import store_layout

    new_lay = store_layout(new_index, tile)
    fmap = np.asarray(src_flat_of_new, np.int64)
    oob = np.iinfo(np.int32).max
    if len(src_layout.elem_dest):
        src_store_pos = np.where(
            fmap >= 0,
            src_layout.elem_dest[np.minimum(fmap, len(src_layout.elem_dest) - 1)],
            oob,  # missing -> gathers 0
        )
    else:
        src_store_pos = np.full(len(fmap), oob, dtype=np.int64)
    total = new_lay.n_tiles * tile * tile
    inv = np.full(total, np.iinfo(np.int32).max, dtype=np.int64)
    inv[new_lay.elem_dest] = src_store_pos
    return inv


_store_gather_jit = None


def apply_store_gather(src_data, inv, n_tiles: int, tile: int):
    """Device half: one jitted element gather through a precomposed
    store-position map (eager ``.at[].get`` pays ~100s of ms of host
    advanced-indexing prep PER CALL; under jit that cost is traced
    once per shape). The jitted fn is module-level so the trace cache
    persists across calls."""
    import jax
    import jax.numpy as jnp

    if n_tiles * tile * tile == 0 or src_data.size == 0:
        return jnp.zeros((n_tiles, tile, tile), dtype=src_data.dtype)

    global _store_gather_jit
    if _store_gather_jit is None:

        @partial(jax.jit, static_argnames=("n_tiles", "tile"))
        def _go(flat, m, *, n_tiles, tile):
            return (
                flat.at[m]
                .get(mode="fill", fill_value=0)
                .reshape(n_tiles, tile, tile)
            )

        _store_gather_jit = _go

    return _store_gather_jit(
        src_data.reshape(-1), jnp.asarray(inv), n_tiles=n_tiles, tile=tile
    )


def apply_flat_gather(new_index, tile, src, src_flat_of_new: np.ndarray):
    """Build a new matrix's tile-store data from a FLAT-layout gather map.

    ``src_flat_of_new[e]`` is the source flat-element position of the new
    matrix's flat element ``e``. The map is composed with both tile-store
    layouts on the host (``flat_gather_store_map``), then applied as ONE
    jitted device element gather (``apply_store_gather``).

    This is the compatibility path for block-compacting/permuting
    transformations that cannot be expressed at tile granularity
    (sub-matrix extraction across arbitrary block subsets, tensor layout
    refolds). It is correct everywhere but element-granular, so hot paths
    must not rely on it (see store.py).
    """
    from .store import store_layout

    inv = flat_gather_store_map(new_index, tile, src.layout, src_flat_of_new)
    n_tiles = store_layout(new_index, tile).n_tiles
    return apply_store_gather(src.data, inv, n_tiles, tile)
