"""Scalar-CSR interop: BCSR <-> element-granular CSR conversion.

Analog of ``src/ops/dbcsr_csr_conversions.F:115-156`` (``csr_create_from_dbcsr``,
``convert_dbcsr_to_csr``, ``convert_csr_to_dbcsr``, ``dbcsr_to_csr_filter``,
``csr_write``). The reference's scalar-CSR type exists for interop with
external solvers (e.g. PEXSI); this library's exchange format is
``scipy.sparse.csr_matrix`` on host — the universal Python sparse interop
type — with explicit zeros kept so the blocked structure round-trips.

The reference requires a "CSR-convertible" matrix (row-distributed); here
conversion is layout-independent because data is one flat buffer.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

from ..block.bcsr import BCSRMatrix
from ..core.errors import dbcsr_assert
from ..ops.transform import desymmetrize

__all__ = ["to_csr", "from_csr", "to_csr_filter", "csr_write"]


def to_csr(m: BCSRMatrix) -> sp.csr_matrix:
    """Element-granular CSR of the full matrix (``convert_dbcsr_to_csr``).
    Stored blocks are kept verbatim (explicit zeros inside blocks survive,
    matching the reference's block-granular nonzero structure)."""
    m = desymmetrize(m)
    idx = m.index
    if idx.nblks == 0:
        return sp.csr_matrix((idx.nfullrows, idx.nfullcols), dtype=m.dtype)
    host = m.flat_host()
    bm, bn = idx.blk_shapes
    # element coordinates per flat data slot (row-major inside each block)
    b = idx.elem_to_blk.astype(np.int64)
    t = np.arange(idx.nelems, dtype=np.int64) - idx.blk_offset[b]
    er = idx.row_offsets[idx.blk_rows[b]] + t // bn[b]
    ec = idx.col_offsets[idx.col_idx[b]] + t % bn[b]
    out = sp.coo_matrix(
        (host, (er, ec)), shape=(idx.nfullrows, idx.nfullcols)
    ).tocsr()
    out.sort_indices()
    return out


def to_csr_filter(m: BCSRMatrix, eps: float) -> sp.csr_matrix:
    """Blockwise-filtered conversion (``dbcsr_to_csr_filter``): drop blocks
    with Frobenius norm below ``eps`` before converting."""
    from .arithmetic import filter_blocks

    return to_csr(filter_blocks(desymmetrize(m), eps))


def from_csr(
    csr,
    row_block_sizes,
    col_block_sizes,
    *,
    name: str = "from_csr",
    dist=None,
    keep_zero_blocks: bool = False,
) -> BCSRMatrix:
    """Re-block a scalar CSR matrix (``convert_csr_to_dbcsr``): any block
    containing at least one stored element becomes a stored (dense) block."""
    csr = sp.csr_matrix(csr)
    rbs = np.asarray(row_block_sizes, dtype=np.int32)
    cbs = np.asarray(col_block_sizes, dtype=np.int32)
    ro = np.concatenate([[0], np.cumsum(rbs, dtype=np.int64)])
    co = np.concatenate([[0], np.cumsum(cbs, dtype=np.int64)])
    dbcsr_assert(
        csr.shape == (int(ro[-1]), int(co[-1])),
        f"CSR shape {csr.shape} does not match block sizes "
        f"({int(ro[-1])}, {int(co[-1])})",
    )
    coo = csr.tocoo()
    if keep_zero_blocks:
        brows = np.repeat(np.arange(len(rbs)), len(cbs))
        bcols = np.tile(np.arange(len(cbs)), len(rbs))
    else:
        # block coordinate of every stored element -> unique occupied blocks
        er = np.searchsorted(ro, coo.row, side="right") - 1
        ec = np.searchsorted(co, coo.col, side="right") - 1
        keys = np.unique(er.astype(np.int64) * len(cbs) + ec)
        brows = (keys // len(cbs)).astype(np.int64)
        bcols = (keys % len(cbs)).astype(np.int64)
    blocks = []
    for i, j in zip(brows, bcols):
        sub = csr[ro[i]:ro[i + 1], co[j]:co[j + 1]]
        blocks.append(np.asarray(sub.todense()))
    return BCSRMatrix.from_blocks(
        brows, bcols, blocks, rbs, cbs, name=name, dist=dist, dtype=csr.dtype
    )


def csr_write(csr, path_or_file, *, threshold: Optional[float] = None) -> None:
    """Write a CSR matrix in coordinate text format, one ``row col value``
    line per entry, 1-based indices (``csr_write`` analog, the reference's
    external-solver exchange dump)."""
    csr = sp.csr_matrix(csr).tocoo()
    own = isinstance(path_or_file, str)
    f = open(path_or_file, "w") if own else path_or_file
    try:
        print(f"% {csr.shape[0]} {csr.shape[1]} {csr.nnz}", file=f)
        for r, c, v in zip(csr.row, csr.col, csr.data):
            if threshold is not None and abs(v) < threshold:
                continue
            print(f"{int(r) + 1} {int(c) + 1} {v:.17g}", file=f)
    finally:
        if own:
            f.close()
