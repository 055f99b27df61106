"""TAS (tall-and-skinny) layer tests.

Mirrors the reference's ``tests/dbcsr_tas_unittest.F:59-120``: tall random
matrices multiplied in every transpose/orientation combination, validated
against a dense oracle (the reference validates with ``dbcsr_tas_checksum``
against a reference multiply via conversion).
"""
import numpy as np
import pytest

import dbcsr_tpu as dt
from dbcsr_tpu.tas import (
    BatchedTAS,
    TASSplit,
    extract_block_subset,
    result_index_estimate,
    split_factor_estimate,
    tas_from_matrix,
    tas_multiply,
)

RNG = np.random.default_rng(42)


def _bs(n, rng):
    return dt.random_block_sizes(n, [2, 3, 5], rng)


def _mat(rbs, cbs, occ, rng, name):
    return dt.random_matrix(rbs, cbs, occ, rng, dtype=np.float64, name=name)


def _tall(nlong, nshort, occ, rng, name):
    return _mat(_bs(nlong, rng), _bs(nshort, rng), occ, rng, name)


def _check(transa, transb, a, b, out, alpha=1.0):
    da = np.asarray(a.to_dense())
    db = np.asarray(b.to_dense())
    if transa == "T":
        da = da.T
    if transb == "T":
        db = db.T
    ref = alpha * (da @ db)
    got = np.asarray(out.matrix.to_dense())
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10)


# the 6 orientation combos of the reference unittest
# (tests/dbcsr_tas_unittest.F:59-120): (m,k,n) block counts with one long
# dimension, all transpose arrangements. Block-size vectors are shared so
# inner dimensions are compatible.
@pytest.mark.parametrize(
    "transa,transb,m,k,n",
    [
        ("N", "N", 40, 6, 7),   # m long
        ("T", "N", 7, 40, 6),   # k long
        ("N", "T", 6, 7, 40),   # n long
        ("T", "T", 40, 6, 7),   # m long, both transposed
        ("N", "N", 6, 40, 7),   # k long
        ("T", "N", 6, 7, 44),   # n long
    ],
)
def test_tas_multiply_orientations(transa, transb, m, k, n):
    rng = np.random.default_rng(hash((transa, transb, m, k, n)) % 2**32)
    mbs, kbs, nbs = _bs(m, rng), _bs(k, rng), _bs(n, rng)
    a = _mat(kbs if transa == "T" else mbs, mbs if transa == "T" else kbs,
             0.4, rng, "A")
    b = _mat(nbs if transb == "T" else kbs, kbs if transb == "T" else nbs,
             0.4, rng, "B")
    out = tas_multiply(transa, transb, 1.0, a, b, nsplit=3)
    _check(transa, transb, a, b, out)


def test_tas_multiply_auto_split_and_flops():
    rng = np.random.default_rng(7)
    mbs, kbs, nbs = _bs(60, rng), _bs(5, rng), _bs(6, rng)
    a = _mat(mbs, kbs, 0.3, rng, "A")
    b = _mat(kbs, nbs, 0.8, rng, "B")
    out, fl = tas_multiply("N", "N", 2.0, a, b, return_flops=True)
    assert fl > 0
    _check("N", "N", a, b, out, alpha=2.0)


def test_tas_multiply_beta_accumulate():
    rng = np.random.default_rng(8)
    mbs, kbs, nbs = _bs(30, rng), _bs(4, rng), _bs(5, rng)
    a = _mat(mbs, kbs, 0.4, rng, "A")
    b = _mat(kbs, nbs, 0.7, rng, "B")
    m_bs = a.row_block_sizes
    n_bs = b.col_block_sizes
    c0 = dt.random_matrix(m_bs, n_bs, 0.5, rng, dtype=np.float64, name="C")
    out = tas_multiply("N", "N", 1.0, a, b, beta=0.5, c=c0, nsplit=4)
    ref = np.asarray(a.to_dense()) @ np.asarray(b.to_dense()) + 0.5 * np.asarray(
        c0.to_dense()
    )
    np.testing.assert_allclose(
        np.asarray(out.matrix.to_dense()), ref, rtol=1e-10, atol=1e-10
    )


def test_tas_multiply_k_split_filter_eps():
    rng = np.random.default_rng(9)
    mbs, kbs, nbs = _bs(5, rng), _bs(50, rng), _bs(6, rng)
    a = _mat(mbs, kbs, 0.4, rng, "A")  # k = 50 blocks long
    b = _mat(kbs, nbs, 0.4, rng, "B")
    out = tas_multiply("N", "N", 1.0, a, b, nsplit=5, filter_eps=1e-12)
    _check("N", "N", a, b, out)


def test_split_factor_estimate_picks_long_dim():
    dim, ns = split_factor_estimate(100000, 100, 100)
    assert dim == "m" and ns > 1
    dim, _ = split_factor_estimate(10, 99999, 10)
    assert dim == "k"
    dim, ns = split_factor_estimate(10, 10, 10)
    assert ns == 1


def test_result_index_estimate_matches_actual():
    rng = np.random.default_rng(10)
    mbs, kbs, nbs = _bs(20, rng), _bs(6, rng), _bs(8, rng)
    a = _mat(mbs, kbs, 0.3, rng, "A")
    b = _mat(kbs, nbs, 0.5, rng, "B")
    rows, cols, fl = result_index_estimate(a, "N", b, "N")
    out = tas_multiply("N", "N", 1.0, a, b, nsplit=2).matrix
    assert set(zip(rows.tolist(), cols.tolist())) == set(
        zip(out.index.blk_rows.tolist(), out.index.col_idx.tolist())
    )
    assert fl > 0


def test_extract_block_subset_roundtrip():
    rng = np.random.default_rng(11)
    m = _tall(40, 8, 0.5, rng, "M")
    rows = np.array([1, 3, 7], dtype=np.int32)
    assert m.nblkrows > 8
    sub = extract_block_subset(m, row_blocks=rows)
    dense = np.asarray(m.to_dense())
    ro = np.concatenate([[0], np.cumsum(m.row_block_sizes)])
    expected = np.concatenate([dense[ro[r]:ro[r + 1]] for r in rows])
    np.testing.assert_allclose(np.asarray(sub.to_dense()), expected)


def test_tas_split_maps():
    s = TASSplit.cyclic("R", 10, 3)
    assert s.nsplit == 3
    cover = np.concatenate([s.blocks_of_group(g) for g in range(3)])
    assert sorted(cover.tolist()) == list(range(10))
    lo = s.local_of_global()
    assert lo[0] == 0 and lo[3] == 1  # block 3 is the 2nd of group 0
    s2 = TASSplit.contiguous("C", 10, 4)
    assert (np.diff(s2.group_of_block) >= 0).all()


def test_batched_tas_reuses_plan():
    rng = np.random.default_rng(12)
    mbs, kbs, nbs = _bs(15, rng), _bs(5, rng), _bs(6, rng)
    a = _mat(mbs, kbs, 0.4, rng, "A")
    b = _mat(kbs, nbs, 0.6, rng, "B")
    ref = np.asarray(a.to_dense()) @ np.asarray(b.to_dense())
    with BatchedTAS() as batch:
        out1 = batch.multiply("N", "N", a, b)
        # new data, same pattern -> cached executor
        a2 = a.with_data(a.data * 2.0)
        out2 = batch.multiply("N", "N", a2, b)
        assert len(batch._cache) == 1
    np.testing.assert_allclose(np.asarray(out1.to_dense()), ref, atol=1e-10)
    np.testing.assert_allclose(
        np.asarray(out2.to_dense()), 2.0 * ref, atol=1e-10
    )


def test_tas_from_matrix_picks_long_dim():
    rng = np.random.default_rng(13)
    tall = _tall(50, 4, 0.3, rng, "T")
    t = tas_from_matrix(tall, nsplit=4)
    assert t.split.rowcol == "R" and t.nsplit == 4
    wide = dt.transpose(tall)
    t2 = tas_from_matrix(wide, nsplit=4)
    assert t2.split.rowcol == "C"
