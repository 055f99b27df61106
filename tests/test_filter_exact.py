"""Exact filter-semantics parity with the reference.

Pins the ``filter_mode="exact"`` surviving pattern against a brute-force
oracle of the reference's rule: a triple contributes iff its single product
of squared f32 block norms clears the per-row threshold
``(eps/row_count)²`` (``/root/reference/src/mm/dbcsr_mm_csr.F:260-280``,
row counts ``src/mm/dbcsr_mm_cannon.F:1042-1113``); a C block exists iff
any triple contributes. Also pins the documented equivalence envelope: the
default "sum" rule produces a superset of the exact pattern, and after the
mandatory post-multiply Frobenius filter both modes agree on kept blocks
above eps.
"""
import numpy as np
import pytest

import dbcsr_tpu as dt

from dbcsr_tpu.core.config import get_config, set_config
from dbcsr_tpu.mm.plan import symbolic_product


def _oracle_pattern(a, b, eps, *, per_row_eps=True):
    """Brute-force reference rule over dense pattern/norm arrays."""
    na = np.asarray(dt.block_norms(a)).astype(np.float32) ** 2
    nb = np.asarray(dt.block_norms(b)).astype(np.float32) ** 2
    A = np.zeros((a.nblkrows, a.nblkcols), dtype=np.float32)
    pres_a = np.zeros_like(A, dtype=bool)
    for bid, (r, c) in enumerate(zip(a.index.blk_rows, a.index.col_idx)):
        A[r, c] = na[bid]
        pres_a[r, c] = True
    B = np.zeros((b.nblkrows, b.nblkcols), dtype=np.float32)
    pres_b = np.zeros_like(B, dtype=bool)
    for bid, (r, c) in enumerate(zip(b.index.blk_rows, b.index.col_idx)):
        B[r, c] = nb[bid]
        pres_b[r, c] = True
    row_counts = np.maximum(pres_a.sum(axis=1), 1)
    surv = set()
    for i in range(a.nblkrows):
        thr = (
            (np.float32(eps) / np.float32(row_counts[i])) ** 2
            if per_row_eps
            else np.float32(eps) ** 2
        )
        for k in range(a.nblkcols):
            if not pres_a[i, k]:
                continue
            for j in range(b.nblkcols):
                if not pres_b[k, j]:
                    continue
                if A[i, k] * B[k, j] >= thr:
                    surv.add((i, j))
    return surv


def _spread_norms(m, rng):
    """Scale each stored tile by a random factor spanning decades so the
    filter thresholds actually bite at varied places."""
    from dataclasses import replace

    scales = 10.0 ** rng.uniform(-4, 0, size=(m.data.shape[0], 1, 1))
    return replace(m, data=m.data * scales)


@pytest.mark.parametrize("per_row", [True, False])
@pytest.mark.parametrize("eps", [1e-3, 3e-2, 0.5])
def test_exact_pattern_matches_oracle(rng, eps, per_row):
    rbs = dt.random_block_sizes(25, [2, 3, 5], rng)
    a = _spread_norms(dt.random_matrix(rbs, rbs, 0.4, rng, dtype=np.float64), rng)
    b = _spread_norms(dt.random_matrix(rbs, rbs, 0.4, rng, dtype=np.float64), rng)
    na = np.asarray(dt.block_norms(a)).astype(np.float32) ** 2
    nb = np.asarray(dt.block_norms(b)).astype(np.float32) ** 2
    symb = symbolic_product(
        a.index, False, b.index, False,
        a_norms_sq=na, b_norms_sq=nb, filter_eps=eps,
        per_row_eps=per_row, filter_mode="exact",
    )
    got = set(zip(symb.rows.tolist(), symb.cols.tolist()))
    want = _oracle_pattern(a, b, eps, per_row_eps=per_row)
    assert got == want


@pytest.mark.parametrize("eps", [1e-3, 1e-1])
def test_sum_mode_is_superset(rng, eps):
    rbs = dt.random_block_sizes(30, [2, 4], rng)
    a = _spread_norms(dt.random_matrix(rbs, rbs, 0.35, rng, dtype=np.float64), rng)
    b = _spread_norms(dt.random_matrix(rbs, rbs, 0.35, rng, dtype=np.float64), rng)
    na = np.asarray(dt.block_norms(a)).astype(np.float32) ** 2
    nb = np.asarray(dt.block_norms(b)).astype(np.float32) ** 2
    kw = dict(a_norms_sq=na, b_norms_sq=nb, filter_eps=eps)
    exact = symbolic_product(
        a.index, False, b.index, False, filter_mode="exact", **kw
    )
    summ = symbolic_product(
        a.index, False, b.index, False, filter_mode="sum", **kw
    )
    se = set(zip(exact.rows.tolist(), exact.cols.tolist()))
    ss = set(zip(summ.rows.tolist(), summ.cols.tolist()))
    assert se <= ss
    # exact mode counts only surviving triples — never more flops than sum
    assert exact.eff_flops <= summ.eff_flops + 1e-9


def test_exact_mode_end_to_end(rng):
    """multiply() under filter_mode=exact stays numerically correct and
    both modes agree on kept blocks after the post-filter."""
    rbs = dt.random_block_sizes(30, [3, 5], rng)
    a = dt.random_matrix(rbs, rbs, 0.3, rng, dtype=np.float64)
    b = dt.random_matrix(rbs, rbs, 0.3, rng, dtype=np.float64)
    eps = 1e-1
    old = get_config().filter_mode
    try:
        set_config(filter_mode="exact")
        c_exact = dt.multiply("N", "N", 1.0, a, b, filter_eps=eps)
        set_config(filter_mode="sum")
        c_sum = dt.multiply("N", "N", 1.0, a, b, filter_eps=eps)
    finally:
        set_config(filter_mode=old)
    ref = np.asarray(a.to_dense()) @ np.asarray(b.to_dense())
    for c in (c_exact, c_sum):
        diff = np.abs(np.asarray(c.to_dense()) - ref)
        assert diff.max() <= eps * 10
        nrm = np.asarray(dt.block_norms(c))
        assert (nrm >= eps * 0.999).all()
    # kept blocks clearly above eps agree between the two modes
    ke = set(zip(c_exact.index.blk_rows.tolist(), c_exact.index.col_idx.tolist()))
    ks = set(zip(c_sum.index.blk_rows.tolist(), c_sum.index.col_idx.tolist()))
    for (r, c_) in ks - ke:
        blk = c_sum.get_block(r, c_)
        assert np.linalg.norm(blk) <= eps * 1.001
