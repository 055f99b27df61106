"""Tests for the perf driver, the built-in self-test API, multiply limits
and the replication ops — the reference's unittest4/perf-driver surface.
"""
import os

import numpy as np
import pytest

import dbcsr_tpu as dt
from dbcsr_tpu import testing
from dbcsr_tpu.ops.transform import distribute, replicate_all, sum_replicated
from dbcsr_tpu.perf import parse_perf, run_perf

HERE = os.path.dirname(os.path.abspath(__file__))


def test_parse_perf_square():
    cfg = parse_perf(os.path.join(HERE, "inputs", "square_sparse.perf"))
    assert (cfg.m, cfg.n, cfg.k) == (1000, 1000, 1000)
    assert cfg.sparsity_a == pytest.approx(0.9)
    assert cfg.nrep == 3
    assert cfg.m_blocks == [(1, 5)]
    # checksum ref from the numpy f64 oracle (tools/apply_checksums.py)
    assert cfg.check_checksum and len(cfg.checksum_refs) == 1


def test_parse_perf_mixed():
    cfg = parse_perf(os.path.join(HERE, "inputs", "mixed_blocks.perf"))
    assert cfg.transa == "T"
    assert cfg.alpha == 2.0
    assert cfg.m_blocks == [(1, 5), (1, 13), (1, 23)]
    assert cfg.k_blocks == [(2, 5), (1, 13)]


def test_parse_perf_reference_recipes():
    """All shipped recipes (mirroring the reference's tests/inputs/) parse,
    with their checksum references attached."""
    import glob

    for path in sorted(glob.glob(os.path.join(HERE, "inputs", "*.perf"))):
        cfg = parse_perf(path)
        assert cfg.m > 0 and cfg.n > 0 and cfg.k > 0, path
    h2o = parse_perf(os.path.join(HERE, "inputs", "H2O.perf"))
    assert (h2o.m, h2o.n, h2o.k) == (2208, 2208, 2208)
    assert h2o.m_blocks == [(1, 23)] and h2o.nrep == 50
    assert h2o.check_checksum and h2o.checksum_refs
    rect2 = parse_perf(os.path.join(HERE, "inputs", "rect2_dense.perf"))
    assert rect2.transa == "T" and rect2.k == 1000


def test_run_perf_small(capsys):
    cfg = parse_perf(os.path.join(HERE, "inputs", "mixed_blocks.perf"))
    cfg.m, cfg.n, cfg.k = 92, 46, 69  # shrink for CI
    cfg.nrep = 1
    res = run_perf(cfg, seed=1, verbose=False)
    assert res["eff_flops_per_mult"] > 0
    assert res["mean_time_s"] > 0
    assert np.isfinite(res["checksum"])


def test_multiply_limits_window():
    rng = np.random.default_rng(0)
    bs = dt.random_block_sizes(60, [2, 3], rng)
    a = dt.random_matrix(bs, bs, 0.5, rng, dtype=np.float64)
    b = dt.random_matrix(bs, bs, 0.5, rng, dtype=np.float64)
    nb = len(bs)
    r = (1, nb // 2)
    c_ = (2, nb - 3)
    k = (0, nb // 3)
    out = dt.multiply("N", "N", 1.0, a, b, limits={"rows": r, "cols": c_, "k": k})
    da, db = np.asarray(a.to_dense()), np.asarray(b.to_dense())
    off = np.concatenate([[0], np.cumsum(bs)])
    ref = np.zeros_like(da)
    ref[off[r[0]]:off[r[1]], off[c_[0]]:off[c_[1]]] = (
        da[off[r[0]]:off[r[1]], off[k[0]]:off[k[1]]]
        @ db[off[k[0]]:off[k[1]], off[c_[0]]:off[c_[1]]]
    )
    np.testing.assert_allclose(
        np.asarray(out.to_dense()), ref, rtol=1e-10, atol=1e-10
    )


def test_multiply_limits_with_beta_c():
    rng = np.random.default_rng(1)
    bs = dt.random_block_sizes(40, [2, 3], rng)
    a = dt.random_matrix(bs, bs, 0.6, rng, dtype=np.float64)
    b = dt.random_matrix(bs, bs, 0.6, rng, dtype=np.float64)
    c0 = dt.random_matrix(bs, bs, 0.4, rng, dtype=np.float64)
    nb = len(bs)
    k = (0, nb // 2)
    out = dt.multiply("N", "N", 2.0, a, b, 0.5, c0, limits={"k": k})
    da, db, dc = (np.asarray(x.to_dense()) for x in (a, b, c0))
    off = np.concatenate([[0], np.cumsum(bs)])
    ref = 2.0 * da[:, off[k[0]]:off[k[1]]] @ db[off[k[0]]:off[k[1]], :] + 0.5 * dc
    np.testing.assert_allclose(
        np.asarray(out.to_dense()), ref, rtol=1e-10, atol=1e-10
    )


def test_replicate_distribute_sum():
    rng = np.random.default_rng(2)
    bs = dt.random_block_sizes(30, [2, 3], rng)
    m = dt.random_matrix(bs, bs, 0.4, rng, dtype=np.float64)
    r = replicate_all(m)
    assert r.dist is None
    copies = [m.with_data(m.data * w) for w in (1.0, 2.0, 3.0)]
    s = sum_replicated(copies)
    np.testing.assert_allclose(
        np.asarray(s.to_dense()), 6.0 * np.asarray(m.to_dense()), atol=1e-10
    )
    # distribute round-trips the metadata
    from dbcsr_tpu.dist.distribution import block_cyclic_dist
    from dbcsr_tpu.dist.grid import ProcessGrid

    grid = ProcessGrid.make(1, 1)
    d = block_cyclic_dist(grid, len(bs), len(bs))
    dm = distribute(m, d)
    assert dm.dist is d


def test_builtin_self_tests():
    assert testing.test_mm(nblkrows=24, nblkcols=20, nblkks=22, seed=3)
    assert testing.test_binary_io(seed=3)


def test_check_multiply_detects_corruption():
    rng = np.random.default_rng(4)
    bs = dt.random_block_sizes(20, [2, 3], rng)
    a = dt.random_matrix(bs, bs, 0.6, rng, dtype=np.float64)
    b = dt.random_matrix(bs, bs, 0.6, rng, dtype=np.float64)
    good = dt.multiply("N", "N", 1.0, a, b)
    assert testing.check_multiply("N", "N", 1.0, a, b, 0.0, None, good)
    bad = good.with_data(good.data + 1.0)
    assert not testing.check_multiply("N", "N", 1.0, a, b, 0.0, None, bad)


def test_impose_sparsity():
    rng = np.random.default_rng(5)
    bs = np.array([2, 2], dtype=np.int32)
    m = dt.BCSRMatrix.from_blocks(
        [0], [1], [np.ones((2, 2))], bs, bs, dtype=np.float64
    )
    dense = np.arange(16.0).reshape(4, 4)
    out = testing.impose_sparsity(dense, m)
    assert out[0, 2] == dense[0, 2]
    assert out[0, 0] == 0.0 and out[2, 2] == 0.0
