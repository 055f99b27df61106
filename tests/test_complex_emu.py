"""Split-complex emulation (z/c classes on backends without complex HLO).

Forces the capability check to report "no complex support" so the emulated
paths run on the CPU suite every time.
Reference: 4-type fypp instantiation ``src/data/dbcsr.fypp:15-28``.
"""
import numpy as np
import pytest

import dbcsr_tpu as dt

from dbcsr_tpu.core import machine


@pytest.fixture
def force_emulation():
    import jax

    key = jax.devices()[0].platform
    old = dict(machine._COMPLEX_OK)
    machine._COMPLEX_OK[key] = False
    try:
        yield
    finally:
        machine._COMPLEX_OK.clear()
        machine._COMPLEX_OK.update(old)


def dense(m):
    return np.asarray(m.to_dense())


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_emulated_storage_roundtrip(rng, force_emulation, dtype):
    bs = dt.random_block_sizes(20, [2, 3], rng)
    a = dt.random_matrix(bs, bs, 0.5, rng, dtype=dtype)
    assert a.is_complex_emulated
    assert a.dtype == np.dtype(dtype)
    assert not np.iscomplexobj(np.asarray(a.data))
    flat = a.flat_host()
    assert np.iscomplexobj(flat)
    b = dt.BCSRMatrix.from_flat(a.index, flat, tile=a.tile)
    np.testing.assert_allclose(dense(b), dense(a))
    # block access reflects re+im
    r0, c0 = int(a.index.blk_rows[0]), int(a.index.col_idx[0])
    blk = a.get_block(r0, c0)
    assert np.iscomplexobj(blk)


def test_emulated_multiply_all_trans(rng, force_emulation):
    bs = dt.random_block_sizes(20, [2, 4], rng)
    a = dt.random_matrix(bs, bs, 0.5, rng, dtype=np.complex128)
    b = dt.random_matrix(bs, bs, 0.5, rng, dtype=np.complex128)
    da, db = dense(a), dense(b)
    for transa, opa in (("N", da), ("T", da.T), ("C", da.conj().T)):
        for transb, opb in (("N", db), ("T", db.T), ("C", db.conj().T)):
            c = dt.multiply(transa, transb, 1.0 - 0.5j, a, b)
            assert c.is_complex_emulated
            np.testing.assert_allclose(
                dense(c), (1.0 - 0.5j) * (opa @ opb), atol=1e-12,
                err_msg=f"{transa}{transb}",
            )


def test_emulated_multiply_beta_c(rng, force_emulation):
    bs = dt.random_block_sizes(16, [3], rng)
    a = dt.random_matrix(bs, bs, 0.5, rng, dtype=np.complex128)
    b = dt.random_matrix(bs, bs, 0.5, rng, dtype=np.complex128)
    c0 = dt.random_matrix(bs, bs, 0.4, rng, dtype=np.complex128)
    c = dt.multiply("N", "N", 2.0 + 1.0j, a, b, beta=0.5 - 2.0j, c=c0)
    ref = (2.0 + 1.0j) * (dense(a) @ dense(b)) + (0.5 - 2.0j) * dense(c0)
    np.testing.assert_allclose(dense(c), ref, atol=1e-12)


def test_emulated_hermitian(rng, force_emulation):
    bs = dt.random_block_sizes(16, [2, 3], rng)
    h = dt.random_matrix(bs, bs, 0.6, rng, dtype=np.complex128, sym="H")
    assert h.is_complex_emulated
    dh = dense(h)
    np.testing.assert_allclose(dh, dh.conj().T)
    c = dt.multiply("C", "N", 1.0, h, h)
    np.testing.assert_allclose(dense(c), dh.conj().T @ dh, atol=1e-12)


def test_emulated_elementwise_and_reductions(rng, force_emulation):
    bs = dt.random_block_sizes(14, [2, 3], rng)
    m = dt.random_matrix(bs, bs, 0.6, rng, dtype=np.complex128)
    dm = dense(m)
    assert dt.norm_frobenius(m) == pytest.approx(np.linalg.norm(dm), rel=1e-6)
    assert dt.norm_maxabs(m) == pytest.approx(np.abs(dm).max(), rel=1e-6)
    assert dt.trace(m) == pytest.approx(np.trace(dm), rel=1e-10)
    s = dt.scale(m, 1.5 - 0.5j)
    np.testing.assert_allclose(dense(s), (1.5 - 0.5j) * dm, atol=1e-12)
    h = dt.hadamard_product(m, m)
    np.testing.assert_allclose(dense(h), dm * dm, atol=1e-12)
    other = dt.random_matrix(bs, bs, 0.6, rng, dtype=np.complex128)
    dsum = dt.add(1.0 + 1.0j, m, 2.0, other)
    np.testing.assert_allclose(
        dense(dsum), (1.0 + 1.0j) * dm + 2.0 * dense(other), atol=1e-12
    )
    got = dt.dot(m, other)
    want = np.vdot(dm, dense(other))
    assert got == pytest.approx(want, rel=1e-10)


def test_emulated_transpose_and_filter(rng, force_emulation):
    bs = dt.random_block_sizes(14, [2, 3], rng)
    m = dt.random_matrix(bs, bs, 0.5, rng, dtype=np.complex128)
    dm = dense(m)
    t = dt.transpose(m, conjugate=True)
    np.testing.assert_allclose(dense(t), dm.conj().T, atol=1e-14)
    f = dt.filter_blocks(dt.scale(m, 1e-3), 1e-2)
    nrm = np.asarray(dt.block_norms(f))
    assert (nrm >= 1e-2 * 0.999).all() or f.nblks == 0


def test_emulated_tas_and_io(rng, force_emulation, tmp_path):
    from dbcsr_tpu.ops.io import binary_read, binary_write, checksum
    from dbcsr_tpu.tas import tas_multiply

    mbs = dt.random_block_sizes(30, [2, 3], rng)
    kbs = dt.random_block_sizes(8, [2], rng)
    nbs = dt.random_block_sizes(10, [3], rng)
    a = dt.random_matrix(mbs, kbs, 0.4, rng, dtype=np.complex128)
    b = dt.random_matrix(kbs, nbs, 0.7, rng, dtype=np.complex128)
    out = tas_multiply("N", "N", 1.0 + 1.0j, a, b, nsplit=3)
    ref = (1.0 + 1.0j) * dense(a) @ dense(b)
    np.testing.assert_allclose(dense(out.matrix), ref, atol=1e-12)
    # checkpoint roundtrip stays complex through the flat-host layer
    p = str(tmp_path / "m.bin")
    binary_write(a, p)
    back = binary_read(p)
    np.testing.assert_allclose(dense(back), dense(a))
    assert checksum(back) == pytest.approx(checksum(a))


def test_emulated_multiply_filter_eps(rng, force_emulation):
    bs = dt.random_block_sizes(20, [3], rng)
    a = dt.random_matrix(bs, bs, 0.4, rng, dtype=np.complex128)
    b = dt.random_matrix(bs, bs, 0.4, rng, dtype=np.complex128)
    eps = 1e-1
    c = dt.multiply("N", "N", 1.0, a, b, filter_eps=eps)
    ref = dense(a) @ dense(b)
    assert np.abs(dense(c) - ref).max() <= eps * 10
    if c.nblks:
        assert (np.asarray(dt.block_norms(c)) >= eps * 0.999).all()


def test_emulated_matches_native_property(rng, force_emulation):
    """Strong oracle: the SAME random inputs through the emulated path and
    (by lifting the probe) the native complex path must agree to f64
    roundoff — ops sweep over random patterns/shapes."""
    from dbcsr_tpu.core import machine

    import jax as _jax

    key = _jax.devices()[0].platform
    # the native leg needs a backend that does complex natively (the
    # fixture forced False)
    del machine._COMPLEX_OK[key]
    really_supported = machine.backend_supports_complex()
    machine._COMPLEX_OK[key] = False
    if not really_supported:
        pytest.skip(
            "backend has no native complex path to compare against "
            "(the emulated path is covered by the other tests here)"
        )
    for trial in range(3):
        bs = dt.random_block_sizes(10 + 6 * trial, [2, 3, 4], rng)
        kbs = dt.random_block_sizes(12 + 4 * trial, [2, 5], rng)
        a = dt.random_matrix(bs, kbs, 0.5, rng, dtype=np.complex128)
        b = dt.random_matrix(kbs, bs, 0.5, rng, dtype=np.complex128)
        assert a.is_complex_emulated
        flat_a, flat_b = a.flat_host(), b.flat_host()

        # emulated results
        c_e = dt.multiply("N", "N", 1.5 - 0.5j, a, b)
        t_e = dt.trace(dt.multiply("N", "N", 1.0, a, b))
        f_e = dt.norm_frobenius(a)

        # native results (probe un-forced)
        machine._COMPLEX_OK[key] = True
        an = dt.BCSRMatrix.from_flat(a.index, flat_a, tile=a.tile)
        bn = dt.BCSRMatrix.from_flat(b.index, flat_b, tile=b.tile)
        assert not an.is_complex_emulated
        c_n = dt.multiply("N", "N", 1.5 - 0.5j, an, bn)
        t_n = dt.trace(dt.multiply("N", "N", 1.0, an, bn))
        f_n = dt.norm_frobenius(an)
        machine._COMPLEX_OK[key] = False

        np.testing.assert_allclose(
            np.asarray(c_e.to_dense()), np.asarray(c_n.to_dense()),
            atol=1e-12,
        )
        assert t_e == pytest.approx(t_n, rel=1e-10)
        assert f_e == pytest.approx(f_n, rel=1e-10)
