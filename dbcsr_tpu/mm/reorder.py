"""Locality-aware block and tile renumbering.

The reference serves linear-scaling SCF patterns whose blocks cluster
around a (possibly hidden) 1-D locality axis; its dense-limit path
(``dbcsr_may_be_dense``/``make_dense``, ``src/mm/dbcsr_mm.F:771-810``)
exploits such structure only when the numbering already exposes it. A
clustered-but-scrambled numbering spreads every block row over many
tiles. This module recovers the hidden axis: a reverse-Cuthill-McKee
bandwidth-reduction pass over the **bipartite union graph** (m-, k- and
n- nodes; edges = A and B entries) renumbers all three dimensions so
coupled rows get nearby ids. Users apply it once, at construction, with
:func:`locality_block_permutation` and :func:`permute_blocks`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee

__all__ = [
    "ReorderPlan",
    "locality_reorder_plan",
    "locality_block_permutation",
    "permute_blocks",
    "tile_bandwidth",
]


@dataclass
class ReorderPlan:
    """Tile-grid renumbering shared by A, B and C.

    ``pm/pk/pn`` map old tile row/inner/col ids to new ids; the coords
    arrays are the permuted op-tile coords in NEW store-slot order, and
    ``a_gather/b_gather`` map new store slots to old ones (feed to
    ``jnp.take``)."""

    pm: np.ndarray  # int64 [Mt] old m-tile -> new m-tile
    pk: np.ndarray  # int64 [Kt]
    pn: np.ndarray  # int64 [Nt]
    a_coords: np.ndarray  # int64 [nA, 2]
    b_coords: np.ndarray  # int64 [nB, 2]
    a_gather: np.ndarray  # int32 [nA] new slot -> old slot
    b_gather: np.ndarray  # int32 [nB]

    def c_slot_keys(self, c_keys: np.ndarray, nt: int) -> np.ndarray:
        """Row-major product keys of C's tiles under the new numbering."""
        r = c_keys // nt
        c = c_keys % nt
        return self.pm[r] * np.int64(nt) + self.pn[c]


def tile_bandwidth(coords: np.ndarray) -> int:
    """Max |new_row - new_col| proxy used only for diagnostics."""
    if len(coords) == 0:
        return 0
    return int(np.abs(coords[:, 0] - coords[:, 1]).max())


def locality_block_permutation(a_index, b_index=None):
    """BLOCK-level RCM renumbering ``(pm, pk, pn)`` for ``A·B``.

    The tile store packs ~``T/avg_block`` CONSECUTIVE block rows per
    hardware tile, so locality must exist in the BLOCK numbering before
    the tile layout is built — a clustered-but-scrambled block numbering
    destroys tile packing density and no tile-level pass can recover it.
    This is this library's form of the reference's requirement that callers
    present a dense-friendly ordering for its dense-limit path
    (``src/mm/dbcsr_mm.F:771-810``): compute the hidden locality axis
    once with RCM on the block graph, renumber with
    :func:`permute_blocks`, and every subsequent multiply gets compact
    tiles for free.

    ``pm[i]`` is the new id of A's block-row ``i``; ``pk`` covers A's
    cols == B's rows; ``pn`` B's cols. With ``b_index=None`` (square
    same-pattern chains, A·A-like), one symmetric pass is used and
    ``pm == pk == pn``. Returns None for degenerate inputs."""
    ac = np.stack([a_index.blk_rows, a_index.col_idx], axis=1).astype(
        np.int64
    )
    if b_index is None:
        n = a_index.nblkrows
        if a_index.nblkcols != n:
            raise ValueError("b_index=None requires a square A")
        if len(ac) == 0 or n < 8:
            return None
        g = sp.csr_matrix(
            (np.ones(len(ac), np.int8), (ac[:, 0], ac[:, 1])), shape=(n, n)
        )
        order = np.asarray(
            reverse_cuthill_mckee(g, symmetric_mode=False), dtype=np.int64
        )
        p = np.empty(n, dtype=np.int64)
        p[order] = np.arange(n, dtype=np.int64)
        return p, p, p
    bc = np.stack([b_index.blk_rows, b_index.col_idx], axis=1).astype(
        np.int64
    )
    rp = locality_reorder_plan(
        ac, (a_index.nblkrows, a_index.nblkcols),
        bc, (b_index.nblkrows, b_index.nblkcols),
    )
    if rp is None:
        return None
    return rp.pm, rp.pk, rp.pn


def permute_blocks(m, row_perm, col_perm, *, name: Optional[str] = None):
    """Renumber a matrix's block rows/cols: ``new[p_r[i], p_c[j]] =
    old[i, j]`` (sizes move with their blocks). Host-side repack into the
    new canonical index + tile store — a construction-time cost that
    iterative callers (SCF) amortize over every subsequent multiply.
    Undo with the inverse permutations (``np.argsort(p)``).

    Symmetric/antisymmetric/hermitian matrices: with ``row_perm ==
    col_perm`` the permutation is a similarity transform and the symmetry
    flag is preserved — stored one-triangle blocks whose images cross the
    diagonal are re-stored as their (signed/conjugated) transpose. With
    different row/col permutations the symmetry is broken, so the matrix
    is desymmetrized first and the result carries ``sym='N'``."""
    from ..block.bcsr import (
        SYM_ANTISYMMETRIC,
        SYM_HERMITIAN,
        SYM_NONE,
        BCSRMatrix,
    )
    from ..block.index import build_index

    ix = m.index
    row_perm = np.asarray(row_perm, dtype=np.int64)
    col_perm = np.asarray(col_perm, dtype=np.int64)
    if m.sym != SYM_NONE and not np.array_equal(row_perm, col_perm):
        from ..ops.transform import desymmetrize

        return permute_blocks(
            desymmetrize(m), row_perm, col_perm, name=name
        )
    new_rows = row_perm[ix.blk_rows]
    new_cols = col_perm[ix.col_idx]
    new_rbs = np.empty(ix.nblkrows, dtype=np.int32)
    new_rbs[row_perm] = ix.row_block_sizes
    new_cbs = np.empty(ix.nblkcols, dtype=np.int32)
    new_cbs[col_perm] = ix.col_block_sizes
    flat = m.flat_host()

    if m.sym != SYM_NONE:
        # similarity transform on one-triangle storage: images landing in
        # the strict lower triangle are re-stored transposed at the
        # mirrored coordinate (sign/conjugation per symmetry kind), so the
        # upper-triangle invariant survives
        cross = new_rows > new_cols
        r2 = np.where(cross, new_cols, new_rows)
        c2 = np.where(cross, new_rows, new_cols)
        new_ix, order = build_index(r2, c2, new_rbs, new_cbs)
        out = np.empty(flat.shape, dtype=flat.dtype)
        no = new_ix.blk_offset
        oo = ix.blk_offset
        rbs, cbs = ix.row_block_sizes, ix.col_block_sizes
        for ns, ob in enumerate(order):
            ob = int(ob)
            h = int(rbs[ix.blk_rows[ob]])
            w = int(cbs[ix.col_idx[ob]])
            blk = flat[int(oo[ob]):int(oo[ob + 1])].reshape(h, w)
            if cross[ob]:
                blk = blk.T
                if m.sym == SYM_ANTISYMMETRIC:
                    blk = -blk
                elif m.sym == SYM_HERMITIAN:
                    blk = np.conj(blk)
            out[int(no[ns]):int(no[ns + 1])] = blk.reshape(-1)
        return BCSRMatrix.from_flat(
            new_ix, out, name=name or m.name, sym=m.sym, dist=None,
            tile=m.tile,
        )

    new_ix, order = build_index(new_rows, new_cols, new_rbs, new_cbs)
    # ragged block-granular gather of the flat data into the new order
    lens = np.diff(ix.blk_offset)[order]
    starts = ix.blk_offset[:-1][order]
    base = np.concatenate(([0], np.cumsum(lens)))
    pos = np.arange(int(base[-1]), dtype=np.int64) - np.repeat(
        base[:-1], lens
    )
    new_flat = flat[np.repeat(starts, lens) + pos]
    return BCSRMatrix.from_flat(
        new_ix, new_flat, name=name or m.name, sym=m.sym, dist=None,
        tile=m.tile,
    )


def _rank_of(perm_nodes: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """old-id -> new-id for the nodes in [lo, hi) given the full RCM
    node order."""
    sel = perm_nodes[(perm_nodes >= lo) & (perm_nodes < hi)] - lo
    out = np.empty(hi - lo, dtype=np.int64)
    out[sel] = np.arange(hi - lo, dtype=np.int64)
    return out


def locality_reorder_plan(
    a_coords: np.ndarray,
    a_grid: Tuple[int, int],
    b_coords: np.ndarray,
    b_grid: Tuple[int, int],
) -> Optional[ReorderPlan]:
    """RCM renumbering of the three tile dimensions of op(A)·op(B).

    Returns None for degenerate inputs (empty patterns or tiny grids
    where reordering cannot pay)."""
    mt, kt = a_grid
    kt2, nt = b_grid
    assert kt == kt2
    if len(a_coords) == 0 or len(b_coords) == 0 or mt + kt + nt < 16:
        return None

    n_nodes = mt + kt + nt
    # bipartite union graph: A couples m<->k, B couples k<->n
    rows = np.concatenate(
        [a_coords[:, 0].astype(np.int64), mt + b_coords[:, 0].astype(np.int64)]
    )
    cols = np.concatenate(
        [
            mt + a_coords[:, 1].astype(np.int64),
            mt + kt + b_coords[:, 1].astype(np.int64),
        ]
    )
    data = np.ones(len(rows), dtype=np.int8)
    g = sp.csr_matrix(
        (data, (rows, cols)), shape=(n_nodes, n_nodes)
    )
    perm_nodes = np.asarray(
        reverse_cuthill_mckee(g, symmetric_mode=False), dtype=np.int64
    )
    pm = _rank_of(perm_nodes, 0, mt)
    pk = _rank_of(perm_nodes, mt, mt + kt)
    pn = _rank_of(perm_nodes, mt + kt, n_nodes)

    def permute(coords, prow, pcol, ncol):
        newc = np.stack(
            [prow[coords[:, 0].astype(np.int64)],
             pcol[coords[:, 1].astype(np.int64)]],
            axis=1,
        )
        order = np.argsort(newc[:, 0] * np.int64(ncol) + newc[:, 1])
        return newc[order], order.astype(np.int32)

    a_new, a_gather = permute(a_coords, pm, pk, kt)
    b_new, b_gather = permute(b_coords, pk, pn, nt)
    return ReorderPlan(
        pm=pm, pk=pk, pn=pn,
        a_coords=a_new, b_coords=b_new,
        a_gather=a_gather, b_gather=b_gather,
    )
