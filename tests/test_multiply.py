"""Multiply engine vs dense oracle.

Mirrors the reference's test strategy (SURVEY.md §4 /
``tests/dbcsr_test_multiply.F``): random block-sparse operands, sweep of
transposes × alpha/beta × symmetries × dtypes, oracle = dense matmul on the
expanded matrices, acceptance on eps-scaled residuals. Mixed block sizes
cover the unittest3 "H2O-sized" recipes (5/13/23-style).
"""
import numpy as np
import pytest

import dbcsr_tpu as dt


def dense(m):
    return np.asarray(m.to_dense())


def make(rng, rbs, cbs, occ, dtype, sym="N"):
    return dt.random_matrix(rbs, cbs, occ, rng, dtype=dtype, sym=sym)


def check(c, ref, dtype):
    tol = 1e-5 if np.dtype(dtype).char in "fF" else 1e-12
    scale = max(1.0, np.abs(ref).max())
    assert np.abs(dense(c) - ref).max() <= tol * scale


@pytest.mark.parametrize("transa", ["N", "T"])
@pytest.mark.parametrize("transb", ["N", "T"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_multiply_transposes(rng, transa, transb, dtype):
    rbs = dt.random_block_sizes(40, [2, 3, 5], rng)
    cbs = dt.random_block_sizes(30, [1, 4], rng)
    kbs = dt.random_block_sizes(35, [3, 6], rng)
    a = make(rng, rbs if transa == "N" else kbs, kbs if transa == "N" else rbs, 0.5, dtype)
    b = make(rng, kbs if transb == "N" else cbs, cbs if transb == "N" else kbs, 0.5, dtype)
    c = dt.multiply(transa, transb, 1.0, a, b)
    da = dense(a).T if transa == "T" else dense(a)
    db = dense(b).T if transb == "T" else dense(b)
    check(c, da @ db, dtype)


@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (2.5, 0.0), (1.0, 1.0), (-0.5, 0.3)])
def test_multiply_alpha_beta(rng, alpha, beta):
    rbs = dt.random_block_sizes(30, [2, 5], rng)
    a = make(rng, rbs, rbs, 0.4, np.float64)
    b = make(rng, rbs, rbs, 0.4, np.float64)
    c0 = make(rng, rbs, rbs, 0.3, np.float64)
    c = dt.multiply("N", "N", alpha, a, b, beta=beta, c=c0)
    check(c, alpha * (dense(a) @ dense(b)) + beta * dense(c0), np.float64)


@pytest.mark.parametrize("syma", ["N", "S", "A"])
@pytest.mark.parametrize("symb", ["N", "S"])
def test_multiply_symmetric_inputs(rng, syma, symb):
    rbs = dt.random_block_sizes(25, [2, 3], rng)
    a = make(rng, rbs, rbs, 0.6, np.float64, sym=syma)
    b = make(rng, rbs, rbs, 0.6, np.float64, sym=symb)
    c = dt.multiply("N", "N", 1.0, a, b)
    check(c, dense(a) @ dense(b), np.float64)


def test_multiply_into_symmetric_c(rng):
    """Symmetric product matrix (the reference's canonical symmetric C):
    C := alpha·AᵀA + beta·C with C stored upper-triangular."""
    rbs = dt.random_block_sizes(25, [2, 3], rng)
    kbs = dt.random_block_sizes(20, [2], rng)
    a = make(rng, kbs, rbs, 0.6, np.float64)
    c0 = make(rng, rbs, rbs, 0.4, np.float64, sym="S")
    c = dt.multiply("T", "N", 2.0, a, a, 0.5, c0)
    assert c.sym == "S"
    ref = 2.0 * dense(a).T @ dense(a) + 0.5 * dense(c0)
    check(c, ref, np.float64)


def test_fold_symmetric_roundtrip(rng):
    rbs = dt.random_block_sizes(20, [2, 3], rng)
    s = make(rng, rbs, rbs, 0.6, np.float64, sym="S")
    full = dt.desymmetrize(s)
    from dbcsr_tpu.ops.transform import fold_symmetric

    back = fold_symmetric(full, "S")
    assert back.sym == "S"
    np.testing.assert_allclose(dense(back), dense(s), atol=1e-12)


def test_multiply_complex(rng):
    # runs natively or via split-complex emulation (ops/complex_emu.py)
    rbs = dt.random_block_sizes(20, [2, 4], rng)
    a = make(rng, rbs, rbs, 0.5, np.complex128)
    b = make(rng, rbs, rbs, 0.5, np.complex128)
    c = dt.multiply("C", "N", 1.0 + 0.5j, a, b)
    ref = (1.0 + 0.5j) * (dense(a).conj().T @ dense(b))
    assert np.abs(dense(c) - ref).max() <= 1e-12 * max(1.0, np.abs(ref).max())


def test_multiply_mixed_h2o_sizes(rng):
    """unittest3-style mixed block sizes (5/13/23)."""
    rbs = dt.random_block_sizes(200, [5, 13, 23], rng)
    kbs = dt.random_block_sizes(150, [5, 13, 23], rng)
    cbs = dt.random_block_sizes(180, [5, 13, 23], rng)
    a = make(rng, rbs, kbs, 0.2, np.float64)
    b = make(rng, kbs, cbs, 0.2, np.float64)
    c = dt.multiply("N", "N", 1.0, a, b)
    check(c, dense(a) @ dense(b), np.float64)


def test_multiply_retain_sparsity(rng):
    rbs = dt.random_block_sizes(30, [3, 4], rng)
    a = make(rng, rbs, rbs, 0.5, np.float64)
    b = make(rng, rbs, rbs, 0.5, np.float64)
    c0 = make(rng, rbs, rbs, 0.25, np.float64)
    c = dt.multiply("N", "N", 1.0, a, b, beta=1.0, c=c0, retain_sparsity=True)
    # oracle: dense product with c0's sparsity imposed (dbcsr_impose_sparsity)
    ref = dense(a) @ dense(b) + dense(c0)
    mask = np.zeros_like(ref, dtype=bool)
    ro, co = c0.index.row_offsets, c0.index.col_offsets
    for r, ccol, _ in c0.iter_blocks():
        mask[ro[r]:ro[r + 1], co[ccol]:co[ccol + 1]] = True
    ref = np.where(mask, ref, 0.0)
    assert set(zip(c.index.blk_rows.tolist(), c.index.col_idx.tolist())) == set(
        zip(c0.index.blk_rows.tolist(), c0.index.col_idx.tolist())
    )
    check(c, ref, np.float64)


def test_multiply_filter_eps(rng):
    rbs = dt.random_block_sizes(40, [3, 5], rng)
    a = make(rng, rbs, rbs, 0.3, np.float64)
    b = make(rng, rbs, rbs, 0.3, np.float64)
    eps = 1e-1
    c = dt.multiply("N", "N", 1.0, a, b, filter_eps=eps)
    ref = dense(a) @ dense(b)
    # every surviving block must match the oracle; dropped blocks are small
    got = dense(c)
    diff = np.abs(got - ref)
    # residual bounded by the filter threshold over any block
    assert diff.max() <= eps * 10
    # all kept blocks have norm >= eps
    nrm = np.asarray(dt.block_norms(c))
    assert (nrm >= eps * 0.999).all()


def test_multiply_empty_result(rng):
    rbs = np.array([3, 3], dtype=np.int32)
    a = dt.BCSRMatrix.empty(rbs, rbs, dtype=np.float64)
    b = make(rng, rbs, rbs, 1.0, np.float64)
    c = dt.multiply("N", "N", 1.0, a, b)
    assert c.nblks == 0
    np.testing.assert_allclose(dense(c), 0.0)


def test_multiply_rectangular(rng):
    """unittest2-style: large blocks, rectangular shapes."""
    rbs = np.array([30, 20], dtype=np.int32)
    kbs = np.array([10, 40, 15], dtype=np.int32)
    cbs = np.array([25], dtype=np.int32)
    a = make(rng, rbs, kbs, 0.8, np.float64)
    b = make(rng, kbs, cbs, 0.8, np.float64)
    c = dt.multiply("N", "N", 1.0, a, b)
    check(c, dense(a) @ dense(b), np.float64)
