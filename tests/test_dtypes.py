"""Data-type sweeps (the reference instantiates everything for d/s/z/c via
fypp — ``src/data/dbcsr.fypp``): complex multiplies, hermitian symmetry,
complex TAS and tensor contraction, mixed-precision behavior.
"""
import numpy as np
import pytest

import dbcsr_tpu as dt
from dbcsr_tpu.tas import tas_multiply
from dbcsr_tpu.tensors import TensorBuilder, contract


def _skip_if_unsupported(dtype):
    # complex now ALWAYS runs: natively where the backend supports complex
    # HLO, otherwise through split re/im emulation (ops/complex_emu.py) —
    # z/c are first-class device dtypes
    del dtype


def dense(m):
    return np.asarray(m.to_dense())


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64, np.complex128])
def test_multiply_all_dtypes(rng, dtype):
    _skip_if_unsupported(dtype)
    bs = dt.random_block_sizes(30, [2, 3], rng)
    a = dt.random_matrix(bs, bs, 0.5, rng, dtype=dtype)
    b = dt.random_matrix(bs, bs, 0.5, rng, dtype=dtype)
    c = dt.multiply("N", "N", 1.0, a, b)
    tol = 1e-4 if np.dtype(dtype).char in "fF" else 1e-12
    ref = dense(a) @ dense(b)
    assert np.abs(dense(c) - ref).max() <= tol * max(1.0, np.abs(ref).max())


def test_hermitian_desymmetrize_and_multiply(rng):
    _skip_if_unsupported(np.complex128)
    bs = dt.random_block_sizes(24, [2, 3], rng)
    h = dt.random_matrix(bs, bs, 0.6, rng, dtype=np.complex128, sym="H")
    dh = dense(h)
    np.testing.assert_allclose(dh, dh.conj().T)  # hermitian by construction
    c = dt.multiply("C", "N", 1.0, h, h)
    ref = dh.conj().T @ dh
    np.testing.assert_allclose(dense(c), ref, atol=1e-12)


def test_complex_conjugate_transpose_combos(rng):
    _skip_if_unsupported(np.complex128)
    bs = dt.random_block_sizes(20, [2, 4], rng)
    a = dt.random_matrix(bs, bs, 0.5, rng, dtype=np.complex128)
    b = dt.random_matrix(bs, bs, 0.5, rng, dtype=np.complex128)
    da, db = dense(a), dense(b)
    for transa, opa in (("N", da), ("T", da.T), ("C", da.conj().T)):
        for transb, opb in (("N", db), ("T", db.T), ("C", db.conj().T)):
            c = dt.multiply(transa, transb, 1.0 - 0.5j, a, b)
            np.testing.assert_allclose(
                dense(c), (1.0 - 0.5j) * (opa @ opb), atol=1e-12,
                err_msg=f"{transa}{transb}",
            )


def test_tas_multiply_complex(rng):
    _skip_if_unsupported(np.complex128)
    mbs = dt.random_block_sizes(50, [2, 3], rng)
    kbs = dt.random_block_sizes(8, [2], rng)
    nbs = dt.random_block_sizes(10, [3], rng)
    a = dt.random_matrix(mbs, kbs, 0.4, rng, dtype=np.complex128)
    b = dt.random_matrix(kbs, nbs, 0.7, rng, dtype=np.complex128)
    out = tas_multiply("N", "N", 1.0 + 1.0j, a, b, nsplit=3)
    ref = (1.0 + 1.0j) * dense(a) @ dense(b)
    np.testing.assert_allclose(dense(out.matrix), ref, atol=1e-12)


def test_contract_complex(rng):
    _skip_if_unsupported(np.complex128)
    bs_i, bs_k, bs_j = np.array([2, 3]), np.array([2, 2]), np.array([4])
    def rand_t(shape_bs):
        tb = TensorBuilder(shape_bs, dtype=np.complex128)
        nbpd = [len(b) for b in shape_bs]
        for flat in range(int(np.prod(nbpd))):
            bi = np.unravel_index(flat, nbpd)
            shp = tuple(int(shape_bs[d][bi[d]]) for d in range(len(shape_bs)))
            tb.put_block(
                bi,
                rng.standard_normal(shp) + 1j * rng.standard_normal(shp),
            )
        return tb.finalize()

    a = rand_t([bs_i, bs_k])
    b = rand_t([bs_k, bs_j])
    out = contract(
        1.0, a, b,
        contract_1=(1,), notcontract_1=(0,),
        contract_2=(0,), notcontract_2=(1,),
    )
    ref = np.einsum("ik,kj->ij", a.to_dense(), b.to_dense())
    np.testing.assert_allclose(out.to_dense(), ref, atol=1e-12)


def test_complex_norms_and_ops(rng):
    _skip_if_unsupported(np.complex128)
    bs = dt.random_block_sizes(16, [2, 3], rng)
    m = dt.random_matrix(bs, bs, 0.6, rng, dtype=np.complex128)
    dm = dense(m)
    assert dt.norm_frobenius(m) == pytest.approx(np.linalg.norm(dm), rel=1e-6)
    assert dt.norm_maxabs(m) == pytest.approx(np.abs(dm).max(), rel=1e-6)
    assert dt.trace(m) == pytest.approx(np.trace(dm), rel=1e-10)
    h = dt.hadamard_product(m, m)
    np.testing.assert_allclose(dense(h), dm * dm, atol=1e-12)
