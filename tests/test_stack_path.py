"""Tile-sparse stack path (the libsmm_acc-equivalent engine) vs oracle."""
import numpy as np
import pytest

import dbcsr_tpu as dt

from dbcsr_tpu.core.config import config_override
from dbcsr_tpu.mm.tileplan import plan_tile_stacks_stores


def dense(m):
    return np.asarray(m.to_dense())


@pytest.mark.parametrize("tile", [16, 32])
def test_stack_path_matches_dense(rng, tile):
    rbs = dt.random_block_sizes(120, [3, 5, 7], rng)
    kbs = dt.random_block_sizes(100, [4, 6], rng)
    cbs = dt.random_block_sizes(90, [2, 5], rng)
    a = dt.random_matrix(rbs, kbs, 0.08, rng, dtype=np.float64)
    b = dt.random_matrix(kbs, cbs, 0.08, rng, dtype=np.float64)
    with config_override(mm_driver="xla", tile_size=tile):
        c = dt.multiply("N", "N", 1.0, a, b)
    ref = dense(a) @ dense(b)
    assert np.abs(dense(c) - ref).max() < 1e-12 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("transa,transb", [("T", "N"), ("N", "T"), ("T", "T")])
def test_stack_path_transposes(rng, transa, transb):
    rbs = dt.random_block_sizes(60, [3, 5], rng)
    kbs = dt.random_block_sizes(50, [4], rng)
    a_shape = (rbs, kbs) if transa == "N" else (kbs, rbs)
    b_shape = (kbs, rbs) if transb == "N" else (rbs, kbs)
    a = dt.random_matrix(*a_shape, 0.15, rng, dtype=np.float64)
    b = dt.random_matrix(*b_shape, 0.15, rng, dtype=np.float64)
    with config_override(mm_driver="xla", tile_size=16):
        c = dt.multiply(transa, transb, 1.0, a, b)
    da = dense(a).T if transa == "T" else dense(a)
    db = dense(b).T if transb == "T" else dense(b)
    ref = da @ db
    assert np.abs(dense(c) - ref).max() < 1e-12 * max(1.0, np.abs(ref).max())


def test_stack_path_beta_and_filter(rng):
    rbs = dt.random_block_sizes(80, [5], rng)
    a = dt.random_matrix(rbs, rbs, 0.1, rng, dtype=np.float64)
    b = dt.random_matrix(rbs, rbs, 0.1, rng, dtype=np.float64)
    c0 = dt.random_matrix(rbs, rbs, 0.05, rng, dtype=np.float64)
    with config_override(mm_driver="xla", tile_size=32):
        c = dt.multiply("N", "N", 2.0, a, b, beta=0.5, c=c0)
    ref = 2.0 * dense(a) @ dense(b) + 0.5 * dense(c0)
    assert np.abs(dense(c) - ref).max() < 1e-12 * max(1.0, np.abs(ref).max())


def test_stack_path_empty_product(rng):
    rbs = np.array([4, 4], dtype=np.int32)
    a = dt.BCSRMatrix.empty(rbs, rbs, dtype=np.float64)
    b = dt.random_matrix(rbs, rbs, 1.0, rng, dtype=np.float64)
    c0 = dt.random_matrix(rbs, rbs, 0.5, rng, dtype=np.float64)
    with config_override(mm_driver="xla"):
        c = dt.multiply("N", "N", 1.0, a, b, beta=2.0, c=c0)
    np.testing.assert_allclose(dense(c), 2.0 * dense(c0))


def test_tile_plan_counts(rng):
    """Triple enumeration must match a brute-force tile-level product."""
    rbs = dt.random_block_sizes(64, [3, 5], rng)
    tile = 16
    with config_override(tile_size=tile):
        a = dt.random_matrix(rbs, rbs, 0.2, rng, dtype=np.float64)
        b = dt.random_matrix(rbs, rbs, 0.2, rng, dtype=np.float64)
    la, lb = a.layout, b.layout
    plan = plan_tile_stacks_stores(
        la.tile_coords, (la.ntr, la.ntc), lb.tile_coords, (lb.ntr, lb.ntc)
    )
    # brute force over dense tile occupancy
    da = dense(a) != 0
    db = dense(b) != 0
    mt, kt, nt = plan.tile_grid

    def occ(d, tr, tc):
        pad = np.zeros((tr * tile, tc * tile), dtype=bool)
        pad[: d.shape[0], : d.shape[1]] = d
        return pad.reshape(tr, tile, tc, tile).any(axis=(1, 3))

    oa = occ(da, mt, kt)
    ob = occ(db, kt, nt)
    expected = int(sum(oa[:, k].sum() * ob[k, :].sum() for k in range(kt)))
    assert len(plan.stack) == expected
    # stack sorted by c slot
    assert (np.diff(plan.stack[:, 0]) >= 0).all()
