"""Structural transformations: transpose, desymmetrize, copy, redistribute,
replication, dense conversion.

Analog of ``src/ops/dbcsr_transformations.F:101-150`` (``dbcsr_new_transposed``,
``dbcsr_desymmetrize_deep``, ``dbcsr_complete_redistribute``, ...). On the
tile-store layout, transpose is a tile permutation plus a vectorized
per-tile transpose (no element maps), and desymmetrize is the transposed
store selected on the strict-lower global triangle via a coordinate mask.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..block.bcsr import (
    BCSRMatrix,
    SYM_ANTISYMMETRIC,
    SYM_HERMITIAN,
    SYM_NONE,
    SYM_SYMMETRIC,
)
from ..block.index import build_index
from ..block.store import store_layout
from ..block.tileops import (
    coord_mask,
    take_tiles,
    tile_align_map,
    transpose_store,
)
from ..core.errors import dbcsr_assert
from ..core.timing import timed

__all__ = [
    "transpose",
    "desymmetrize",
    "copy",
    "redistribute",
    "replicate_all",
    "distribute",
    "sum_replicated",
    "complete_redistribute",
    "make_dense",
    "make_undense",
    "may_be_dense",
    "retile",
    "fold_symmetric",
]


def fold_symmetric(m: BCSRMatrix, sym: str = SYM_SYMMETRIC) -> BCSRMatrix:
    """Fold a full matrix into symmetric upper-triangle storage (the inverse
    of :func:`desymmetrize`; the reference's canonical-index fold for
    symmetric product matrices, ``dbcsr_make_index_canonical``,
    ``src/block/dbcsr_index_operations.F``). The strictly-lower content is
    DISCARDED — callers assert the matrix is actually (anti)symmetric/
    hermitian, as in the reference."""
    if m.sym != SYM_NONE:
        return m
    if m.is_complex_emulated:
        sym_re, sym_im = (
            (SYM_SYMMETRIC, SYM_ANTISYMMETRIC)
            if sym == SYM_HERMITIAN
            else (sym, sym)
        )
        re, im = m.parts()
        return BCSRMatrix.combine(
            fold_symmetric(re, sym_re), fold_symmetric(im, sym_im),
            m.dtype, name=m.name, sym=sym,
        )
    with timed("fold_symmetric"):
        keep = m.index.blk_rows <= m.index.col_idx
        rows = m.index.blk_rows[keep]
        cols = m.index.col_idx[keep]
        new_index, _ = build_index(
            rows, cols, m.index.row_block_sizes, m.index.col_block_sizes
        )
        from ..block.tileops import take_tiles, tile_align_map, valid_mask

        keys = store_layout(new_index, m.tile).tile_keys()
        amap = tile_align_map(keys, m.layout.tile_keys())
        data = take_tiles(m.data, amap, m.tile) * valid_mask(
            new_index, m.tile
        ).astype(m.dtype)
        return BCSRMatrix(
            name=m.name, index=new_index, data=data, sym=sym, dist=m.dist
        )


def retile(m: BCSRMatrix, tile: int) -> BCSRMatrix:
    """Re-lay the store at a different hardware tile edge (the autotuner's
    per-workload-class ``tile_size`` knob — see autotune.py). One device
    element gather between the two layouts."""
    if tile == m.tile:
        return m
    if m.is_complex_emulated:
        from .complex_emu import map_parts

        return map_parts(m, lambda x: retile(x, tile))
    from ..block.gather import apply_flat_gather

    data = apply_flat_gather(
        m.index, tile, m, np.arange(m.index.nelems, dtype=np.int64)
    )
    return BCSRMatrix(
        name=m.name, index=m.index, data=data, sym=m.sym, dist=m.dist
    )


def transpose(m: BCSRMatrix, *, conjugate: bool = False) -> BCSRMatrix:
    """Deep transpose (``dbcsr_new_transposed``): tile permutation +
    vectorized per-tile transpose. Symmetric inputs are expanded first; the
    result has symmetry 'N'."""
    if m.is_complex_emulated:
        from ..block.bcsr import BCSRMatrix as _M

        if m.sym != SYM_NONE:
            m = desymmetrize(m)
        re, im = m.parts()
        rr = transpose(re)
        ii = transpose(im)
        if conjugate:
            ii = ii.with_data(-ii.data)
        return _M.combine(rr, ii, m.dtype, name=m.name + "^T", sym=SYM_NONE)
    if m.sym != SYM_NONE:
        m = desymmetrize(m)
    with timed("transpose"):
        new_index, _ = m.index.transposed()
        data, coords_t = transpose_store(
            m.index, m.tile, m.data, conj=conjugate and jnp.iscomplexobj(m.data)
        )
        new_lay = store_layout(new_index, m.tile)
        dbcsr_assert(
            np.array_equal(new_lay.tile_coords, coords_t),
            "transposed tile sets must agree",
        )
        return BCSRMatrix(
            name=m.name + "^T", index=new_index, data=data, sym=SYM_NONE,
            dist=None if m.dist is None else m.dist.transposed(),
        )


def desymmetrize(m: BCSRMatrix) -> BCSRMatrix:
    """Expand a symmetric/antisymmetric/hermitian matrix into full 'N'
    storage (``dbcsr_desymmetrize_deep``): the strictly-lower global
    triangle is the (signed/conjugated) transposed store, selected by a
    coordinate mask — this also reflects the interior of diagonal blocks,
    matching the reference's convention that stored strictly-lower elements
    of diagonal blocks are shadowed by the upper triangle."""
    if m.sym == SYM_NONE:
        return m
    if m.is_complex_emulated:
        from ..block.bcsr import BCSRMatrix as _M

        re, im = m.parts()  # H carries as re 'S' / im 'A'
        return _M.combine(
            desymmetrize(re), desymmetrize(im), m.dtype, name=m.name,
            sym=SYM_NONE,
        )
    with timed("desymmetrize"):
        rows_u = m.index.blk_rows
        cols_u = m.index.col_idx
        off_diag = rows_u != cols_u
        new_rows = np.concatenate([rows_u, cols_u[off_diag]])
        new_cols = np.concatenate([cols_u, rows_u[off_diag]])
        new_index, _ = build_index(
            new_rows, new_cols, m.index.row_block_sizes, m.index.col_block_sizes
        )
        new_lay = store_layout(new_index, m.tile)
        keys = new_lay.tile_keys()

        up = take_tiles(
            m.data, tile_align_map(keys, m.layout.tile_keys()), m.tile
        )
        refl_store, coords_t = transpose_store(m.index, m.tile, m.data)
        keys_t = coords_t[:, 0].astype(np.int64) * new_lay.ntc + coords_t[:, 1]
        refl = take_tiles(refl_store, tile_align_map(keys, keys_t), m.tile)
        if m.sym == SYM_ANTISYMMETRIC:
            refl = -refl
        elif m.sym == SYM_HERMITIAN:
            refl = jnp.conj(refl)
        lower = coord_mask(new_lay, lambda r, c: r > c)
        data = jnp.where(lower, refl, up)
        return BCSRMatrix(
            name=m.name, index=new_index, data=data, sym=SYM_NONE, dist=m.dist
        )


def copy(m: BCSRMatrix, *, name: Optional[str] = None) -> BCSRMatrix:
    return replace(m, name=name or m.name)


def redistribute(m: BCSRMatrix, dist) -> BCSRMatrix:
    """Attach a new distribution (``dbcsr_redistribute``). Data movement is
    implicit: the engine packs per-device panels from the distribution maps,
    so changing distribution is metadata-only here."""
    dbcsr_assert(
        dist is None or dist.compatible_with(m.index),
        "distribution incompatible with block structure",
    )
    return replace(m, dist=dist)


def complete_redistribute(m: BCSRMatrix, dist) -> BCSRMatrix:
    """Arbitrary dist→dist move (``dbcsr_complete_redistribute``,
    ``src/ops/dbcsr_transformations.F:101``). In this library's data model the tile
    store is layout-independent (per-device panels are packed from the
    distribution maps at multiply time), so this is :func:`redistribute`;
    kept as a separate name for API parity with the reference."""
    return redistribute(m, dist)


def replicate_all(m: BCSRMatrix) -> BCSRMatrix:
    """Full replication (``dbcsr_replicate_all``,
    ``src/ops/dbcsr_transformations.F:106``): every process holds the whole
    matrix. This library's form: drop the distribution → the engine treats the
    buffer as replicated (on a multi-host mesh this is the ``all_gather`` of
    the block panels, which packing performs implicitly)."""
    return replace(m, dist=None)


def distribute(m: BCSRMatrix, dist) -> BCSRMatrix:
    """Replicated → distributed (``dbcsr_distribute``): the inverse of
    :func:`replicate_all`; attaches ``dist`` so subsequent multiplies run
    the Cannon path over its mesh."""
    return redistribute(m, dist)


def may_be_dense(m: BCSRMatrix, threshold: float = 0.5) -> bool:
    """Occupancy heuristic for the dense fast path (``dbcsr_may_be_dense``,
    ``src/ops/dbcsr_operations.F``)."""
    return m.occupation() >= threshold


def make_dense(m: BCSRMatrix) -> BCSRMatrix:
    """Sparse-blocked → dense-blocked: one block holding the full matrix
    (``dbcsr_make_dense``, ``src/ops/dbcsr_transformations.F:107`` — the
    reference densifies per distribution bin to hit its dense fast path;
    the engine's dense driver packs panels anyway, so the API-level form
    densifies to a single block)."""
    if m.sym != SYM_NONE:
        m = desymmetrize(m)
    with timed("make_dense"):
        dense = np.asarray(m.to_dense())
        return BCSRMatrix.from_dense(
            dense,
            np.array([m.index.nfullrows], dtype=np.int32),
            np.array([m.index.nfullcols], dtype=np.int32),
            name=m.name,
            keep_zero_blocks=True,
        )


def make_undense(
    m: BCSRMatrix,
    row_block_sizes,
    col_block_sizes,
    *,
    tol: float = 0.0,
    keep_zero_blocks: bool = False,
) -> BCSRMatrix:
    """Dense-blocked → sparse-blocked re-blocking (``dbcsr_make_undense``):
    blocks with Frobenius norm <= ``tol`` are dropped unless
    ``keep_zero_blocks``."""
    with timed("make_undense"):
        return BCSRMatrix.from_dense(
            np.asarray(m.to_dense()),
            row_block_sizes,
            col_block_sizes,
            name=m.name,
            tol=tol,
            keep_zero_blocks=keep_zero_blocks,
            dist=m.dist,
        )


def sum_replicated(copies) -> BCSRMatrix:
    """Element-sum independently updated replicas
    (``dbcsr_sum_replicated``, ``src/ops/dbcsr_operations.F:118`` — the
    reference's ``psum`` over replica contributions). Index patterns may
    differ; the result is the merged pattern."""
    from .arithmetic import add

    copies = list(copies)
    dbcsr_assert(len(copies) > 0, "sum_replicated needs at least one matrix")
    out = copies[0]
    for nxt in copies[1:]:
        out = add(1.0, out, 1.0, nxt)
    return out
