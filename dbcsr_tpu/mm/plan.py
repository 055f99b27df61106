"""Host-side symbolic multiply planning.

Replacement for the reference's hash-table stack builder
(``dbcsr_mm_csr_multiply_low``, ``src/mm/dbcsr_mm_csr.F:178-360``) and the
multrec decomposition: instead of discovering C blocks block-by-block at run
time, the whole symbolic product C-pattern, the epsilon filtering decision
and the effective flop count are computed up front with vectorized sparse
matrix algebra (scipy CSR on block patterns). The device then executes a
fully static gather → GEMM → scatter program.

Filtering semantics follow the reference: with ``filter_eps`` given, the
per-row threshold is ``(eps / row_nk)²`` on the product of *squared*
single-precision block norms (``src/mm/dbcsr_mm_cannon.F:1042-1113``), and
the final result is pruned to blocks with Frobenius norm >= eps
(``multrec_filtering``, ``src/mm/dbcsr_mm_multrec.F:390``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import scipy.sparse as sp

from ..block.index import BCSRIndex

__all__ = ["SymbolicProduct", "symbolic_product", "mnk_statistics"]


@dataclass
class SymbolicProduct:
    """Result pattern + accounting for C = op(A)·op(B)."""

    rows: np.ndarray  # int32 block rows of product C-blocks
    cols: np.ndarray  # int32 block cols
    eff_flops: float  # 2*sum(m*n*k) over contributing triples
    nnz_triples: int


def _weighted_pattern(
    index: BCSRIndex, transpose: bool, values: Optional[np.ndarray]
) -> sp.csr_matrix:
    vals = (
        np.ones(index.nblks, dtype=np.float64)
        if values is None
        else np.asarray(values, dtype=np.float64)
    )
    mat = sp.csr_matrix(
        (vals, index.col_idx.astype(np.int64), index.row_ptr.astype(np.int64)),
        shape=(index.nblkrows, index.nblkcols),
    )
    return (mat.T.tocsr() if transpose else mat)


def _triples_of(pa: sp.csr_matrix, pb: sp.csr_matrix):
    """All contributing (c_row, c_col, a_nnz_pos, b_nnz_pos, k) triples of
    two patterns, fully vectorized (the index algebra of
    ``tileplan.enumerate_tile_triples`` at block granularity). nnz
    positions index the operands' sorted-CSR data order."""
    amat = sp.csr_matrix(
        (
            np.arange(1, pa.nnz + 1, dtype=np.int64),
            pa.tocoo().col.astype(np.int64),
            pa.indptr.astype(np.int64),
        ),
        shape=pa.shape,
    ).tocsc()
    bmat = sp.csr_matrix(
        (
            np.arange(1, pb.nnz + 1, dtype=np.int64),
            pb.tocoo().col.astype(np.int64),
            pb.indptr.astype(np.int64),
        ),
        shape=pb.shape,
    )
    na_k = np.diff(amat.indptr).astype(np.int64)
    nb_k = np.diff(bmat.indptr).astype(np.int64)
    counts = na_k * nb_k
    total = int(counts.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, z, z
    kt = len(na_k)
    k_of_t = np.repeat(np.arange(kt, dtype=np.int64), counts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    t_local = np.arange(total, dtype=np.int64) - starts[k_of_t]
    nb = nb_k[k_of_t]
    a_pos_csc = amat.indptr[k_of_t] + t_local // nb
    b_pos = bmat.indptr[k_of_t] + t_local % nb
    a_pos = amat.data[a_pos_csc] - 1  # position in pa's CSR nnz order
    c_row = amat.indices[a_pos_csc].astype(np.int64)
    c_col = bmat.indices[b_pos].astype(np.int64)
    return c_row, c_col, a_pos, b_pos, k_of_t


def symbolic_product(
    a_index: BCSRIndex,
    transa: bool,
    b_index: BCSRIndex,
    transb: bool,
    *,
    a_norms_sq: Optional[np.ndarray] = None,
    b_norms_sq: Optional[np.ndarray] = None,
    filter_eps: Optional[float] = None,
    per_row_eps: bool = True,
    filter_mode: Optional[str] = None,
) -> SymbolicProduct:
    """Compute the block pattern of op(A)·op(B) with optional filtering.

    ``filter_mode`` (default from config): with ``"sum"``, a C block
    survives when the *sum* of its contributions' norm products clears the
    threshold — a cheap superset of the reference's rule; the difference is
    blocks below eps which the mandatory post-multiply norm filter removes
    anyway. With ``"exact"``, the reference rule is reproduced bit-for-bit
    in pattern space: a triple contributes iff its single product of
    squared f32 block norms clears ``(eps/row_count)²``
    (``src/mm/dbcsr_mm_csr.F:260-280``), a C block survives iff any triple
    contributes, and flops count only contributing triples.
    """
    if filter_mode is None:
        from ..core.config import get_config

        filter_mode = get_config().filter_mode
    pa = _weighted_pattern(a_index, transa, None)
    pb = _weighted_pattern(b_index, transb, None)

    # effective flop accounting: flops(i,j) = 2 * m_i * n_j * sum_k ksize
    m_sizes = (a_index.col_block_sizes if transa else a_index.row_block_sizes)
    k_sizes = (a_index.row_block_sizes if transa else a_index.col_block_sizes)
    n_sizes = (b_index.row_block_sizes if transb else b_index.col_block_sizes)
    ak = pa.multiply(k_sizes.astype(np.float64)[None, :]).tocsr()
    ksum = ak @ pb  # (i,j) -> sum over contributing k of ksize
    ntrip = pa.astype(np.float64) @ pb.astype(np.float64)

    filtering = (
        filter_eps is not None
        and a_norms_sq is not None
        and b_norms_sq is not None
    )

    if filtering and filter_mode == "exact":
        # reference rule: keep triple iff na_sq * nb_sq >= (eps/row_count)^2
        # in f32 (dbcsr_mm_csr.F:260-280); row_count = total op(A) blocks in
        # the row (dbcsr_mm_cannon.F:1068-1113). Materializes all triples —
        # O(block-level flop count) host memory; the "sum" default stays in
        # pattern algebra.
        na = _weighted_pattern(
            a_index, transa, np.maximum(a_norms_sq, 0.0)
        ).tocsr()
        nb = _weighted_pattern(
            b_index, transb, np.maximum(b_norms_sq, 0.0)
        ).tocsr()
        na.sort_indices()
        nb.sort_indices()
        c_row, c_col, a_pos, b_pos, k_of = _triples_of(na, nb)
        if per_row_eps:
            row_counts = np.maximum(np.diff(na.indptr), 1)
            thr = (
                np.float32(filter_eps)
                / row_counts.astype(np.float32)
            ) ** 2
        else:
            thr = np.full(
                na.shape[0], np.float32(filter_eps) ** 2, dtype=np.float32
            )
        pass_mask = (
            na.data.astype(np.float32)[a_pos]
            * nb.data.astype(np.float32)[b_pos]
            >= thr[c_row]
        )
        c_row, c_col, k_of = c_row[pass_mask], c_col[pass_mask], k_of[pass_mask]
        if len(c_row) == 0:
            return SymbolicProduct(
                rows=np.zeros(0, dtype=np.int32),
                cols=np.zeros(0, dtype=np.int32),
                eff_flops=0.0,
                nnz_triples=0,
            )
        # flops count only contributing triples (the reference accumulates
        # flop per surviving stack entry)
        eff = float(
            2.0
            * np.sum(
                m_sizes.astype(np.float64)[c_row]
                * n_sizes.astype(np.float64)[c_col]
                * k_sizes.astype(np.float64)[k_of]
            )
        )
        nt = len(c_row)
        keys = c_row * int(nb.shape[1]) + c_col
        uniq = np.unique(keys)
        rows = (uniq // int(nb.shape[1])).astype(np.int32)
        cols = (uniq % int(nb.shape[1])).astype(np.int32)
        return SymbolicProduct(
            rows=rows, cols=cols, eff_flops=eff, nnz_triples=int(nt)
        )

    if filtering:
        na = _weighted_pattern(a_index, transa, np.maximum(a_norms_sq, 0.0))
        nb = _weighted_pattern(b_index, transb, np.maximum(b_norms_sq, 0.0))
        prod = (na @ nb).tocsr()
        if per_row_eps:
            # row count: total op(A) blocks per row, like the reference
            # (dbcsr_mm_cannon.F:1068-1113)
            row_nk = np.maximum(np.diff(pa.indptr), 1).astype(np.float64)
            thr = (filter_eps / row_nk) ** 2
            scale = sp.diags(1.0 / thr)
            survived = (scale @ prod).tocsr()
            survived.data = (survived.data >= 1.0).astype(np.float64)
            survived.eliminate_zeros()
        else:
            survived = prod.tocsr()
            survived.data = (survived.data >= filter_eps**2).astype(np.float64)
            survived.eliminate_zeros()
        keep = survived
    else:
        keep = ntrip.tocsr()

    keep = keep.tocsr()
    keep.sort_indices()
    coo = keep.tocoo()
    rows = coo.row.astype(np.int32)
    cols = coo.col.astype(np.int32)
    # flops restricted to surviving C blocks
    ksel = np.asarray(ksum.tocsr()[rows, cols]).ravel() if len(rows) else np.zeros(0)
    eff = float(
        2.0
        * np.sum(
            m_sizes.astype(np.float64)[rows]
            * n_sizes.astype(np.float64)[cols]
            * ksel
        )
    )
    tsel = np.asarray(ntrip.tocsr()[rows, cols]).ravel() if len(rows) else np.zeros(0)
    return SymbolicProduct(
        rows=rows, cols=cols, eff_flops=eff, nnz_triples=int(tsel.sum())
    )


def mnk_statistics(
    a_index: BCSRIndex,
    transa: bool,
    b_index: BCSRIndex,
    transb: bool,
    rows: np.ndarray,
    cols: np.ndarray,
    *,
    max_classes: int = 8,
) -> dict:
    """Per-(m,n,k) block-triple counts AND exact effective flops of the
    product restricted to the surviving C blocks — the reference's
    multiplication statistics (``src/mm/dbcsr_mm_sched.F:392-663``,
    STATISTICS report ``dbcsr_mm.F:214-305``).

    Returns ``{(m, n, k): (triple_count, eff_flops)}``. When a dimension
    has more than ``max_classes`` distinct block sizes (real basis sets
    routinely do), the most frequent ``max_classes - 1`` sizes keep their
    own class and the remainder is aggregated into an "other" class labeled
    by the NEGATED rounded count-weighted mean size (e.g. key ``-17`` =
    "sizes averaging ~17, aggregated"); flops stay EXACT for aggregated
    classes because they are summed from true per-triple sizes before
    relabeling. The stats report prints aggregated labels as ``~17``."""
    m_sizes = (a_index.col_block_sizes if transa else a_index.row_block_sizes)
    k_sizes = (a_index.row_block_sizes if transa else a_index.col_block_sizes)
    n_sizes = (b_index.row_block_sizes if transb else b_index.col_block_sizes)
    if len(rows) == 0:
        return {}

    def classify(sizes: np.ndarray) -> np.ndarray:
        """Map each entry of ``sizes`` to its class label (own size, or the
        negated mean for the aggregated tail)."""
        uniq, counts = np.unique(sizes, return_counts=True)
        if len(uniq) <= max_classes:
            return sizes.astype(np.int64)
        keep = uniq[np.argsort(-counts, kind="stable")][: max_classes - 1]
        keep_set = np.isin(sizes, keep)
        tail = sizes[~keep_set]
        other_label = -max(int(round(float(tail.mean()))), 1)
        labels = sizes.astype(np.int64).copy()
        labels[~keep_set] = other_label
        return labels

    m_cls = classify(m_sizes)
    n_cls = classify(n_sizes)
    k_cls = classify(k_sizes)

    pa = _weighted_pattern(a_index, transa, None)
    pb = _weighted_pattern(b_index, transb, None)
    out: dict = {}
    # pack (m_label, n_label) per C block; labels fit comfortably in 24 bits
    mn_key = ((m_cls[rows] + (1 << 22)) << 24) | (n_cls[cols] + (1 << 22))
    mn_flop = (
        m_sizes.astype(np.float64)[rows] * n_sizes.astype(np.float64)[cols]
    )
    for kl in np.unique(k_cls):
        sel = np.flatnonzero(k_cls == kl)
        cnt = (pa[:, sel] @ pb[sel, :]).tocsr()
        per_c = np.asarray(cnt[rows, cols]).ravel()
        # exact sum of k sizes over contributing triples per C block
        ak = pa[:, sel].multiply(k_sizes.astype(np.float64)[sel][None, :])
        ksum = np.asarray((ak.tocsr() @ pb[sel, :]).tocsr()[rows, cols]).ravel()
        nz = per_c > 0
        if not nz.any():
            continue
        uk, inv = np.unique(mn_key[nz], return_inverse=True)
        counts = np.bincount(inv, weights=per_c[nz])
        flops = np.bincount(inv, weights=2.0 * mn_flop[nz] * ksum[nz])
        for key, s, fl in zip(uk, counts, flops):
            m = int(key >> 24) - (1 << 22)
            n = int(key & 0xFFFFFF) - (1 << 22)
            prev_c, prev_f = out.get((m, n, int(kl)), (0, 0.0))
            out[(m, n, int(kl))] = (prev_c + int(s), prev_f + float(fl))
    return out
