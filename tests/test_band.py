"""Band-diagonal (tile-DIA) driver: banded patterns as batched diagonal
matmuls (mm/band.py) — correctness vs the dense oracle and admission
heuristics."""
import numpy as np
import pytest

import dbcsr_tpu as dt

from dbcsr_tpu.block.bcsr import BCSRMatrix
from dbcsr_tpu.block.index import build_index
from dbcsr_tpu.core.config import config_override


TILE = 16


def _banded(rng, n_elems, w, fill=0.7, sizes=(3, 5), off=0, rbs=None):
    if rbs is None:
        rbs = dt.random_block_sizes(n_elems, list(sizes), rng)
    n = len(rbs)
    i = np.repeat(np.arange(n, dtype=np.int64), 2 * w + 1)
    j = i + off + np.tile(np.arange(-w, w + 1, dtype=np.int64), n)
    keep = (j >= 0) & (j < n) & (rng.random(len(j)) < fill)
    idx, _ = build_index(i[keep], j[keep], rbs, rbs)
    return BCSRMatrix.from_flat(idx, rng.standard_normal(idx.nelems))


def dense(m):
    return np.asarray(m.to_dense())


@pytest.mark.parametrize("w_a,w_b", [(2, 2), (4, 1), (1, 5)])
def test_band_driver_matches_oracle(rng, w_a, w_b):
    with config_override(tile_size=TILE, mm_driver="band"):
        a = _banded(rng, 500, w_a)
        b = _banded(rng, 500, w_b, rbs=a.row_block_sizes)
        c = dt.multiply("N", "N", 1.0, a, b)
    ref = dense(a) @ dense(b)
    np.testing.assert_allclose(dense(c), ref, atol=1e-10)


def test_band_off_diagonal_band(rng):
    """Band centered off the main diagonal (asymmetric offsets)."""
    with config_override(tile_size=TILE, mm_driver="band"):
        a = _banded(rng, 400, 2, off=5)
        b = _banded(rng, 400, 2, off=-3, rbs=a.row_block_sizes)
        c = dt.multiply("N", "N", 1.0, a, b)
    np.testing.assert_allclose(dense(c), dense(a) @ dense(b), atol=1e-10)


def test_band_transposes_alpha_beta(rng):
    with config_override(tile_size=TILE, mm_driver="band"):
        a = _banded(rng, 400, 3)
        b = _banded(rng, 400, 2, rbs=a.row_block_sizes)
        c0 = _banded(rng, 400, 1, rbs=a.row_block_sizes)
        c = dt.multiply("T", "N", 2.0, a, b, beta=0.5, c=c0)
    ref = 2.0 * dense(a).T @ dense(b) + 0.5 * dense(c0)
    np.testing.assert_allclose(dense(c), ref, atol=1e-10)


def test_band_executor(rng):
    from dbcsr_tpu.mm.engine import build_multiply_executor

    with config_override(tile_size=TILE):
        a = _banded(rng, 600, 3)
        b = _banded(rng, 600, 3, rbs=a.row_block_sizes)
        fn, c_index, eff = build_multiply_executor(
            "N", "N", a, b, driver="band"
        )
        out = fn(a.data, b.data)
        c = BCSRMatrix(name="c", index=c_index, data=out)
    np.testing.assert_allclose(dense(c), dense(a) @ dense(b), atol=1e-10)
    assert eff > 0


def test_band_rejected_for_wide_patterns(rng):
    """Random (non-banded) patterns must NOT be admitted in auto mode and
    must raise when forced."""
    from dbcsr_tpu.core.errors import DbcsrError

    with config_override(tile_size=TILE):
        rbs = dt.random_block_sizes(300, [3, 5], rng)
        a = dt.random_matrix(rbs, rbs, 0.15, rng, dtype=np.float64)
        b = dt.random_matrix(rbs, rbs, 0.15, rng, dtype=np.float64)
        with config_override(mm_driver="band"):
            with pytest.raises(DbcsrError):
                dt.multiply("N", "N", 1.0, a, b)
        # auto still works (falls to stack/dense)
        c = dt.multiply("N", "N", 1.0, a, b)
    np.testing.assert_allclose(dense(c), dense(a) @ dense(b), atol=1e-10)


def test_band_auto_admission(rng):
    """Auto mode picks the band driver for banded patterns (hardware-flop
    stat reflects the W_a*W_b*Mt diagonal work, not the tile cube)."""
    from dbcsr_tpu.core.stats import get_stats, reset_stats

    with config_override(tile_size=TILE):
        a = _banded(rng, 1500, 2, sizes=(3,))
        b = _banded(rng, 1500, 2, sizes=(3,), rbs=a.row_block_sizes)
        reset_stats()
        c = dt.multiply("N", "N", 1.0, a, b)
        hw = get_stats().hardware_flops
    lay = a.layout
    dense_cube = 2.0 * lay.ntr**3 * TILE**3
    assert 0 < hw < dense_cube  # band work, not the dense cube
    np.testing.assert_allclose(dense(c), dense(a) @ dense(b), atol=1e-10)


@pytest.mark.parametrize("trial", range(4))
def test_band_vs_stack_property(rng, trial):
    """Random band shapes/offsets/rectangular grids: the band driver and
    the stack driver must agree exactly on the same inputs."""
    with config_override(tile_size=TILE):
        n = 300 + 120 * trial
        w = 1 + trial
        off = [-4, 0, 3, 7][trial]
        a = _banded(rng, n, w, fill=0.5 + 0.1 * trial, off=off)
        b = _banded(rng, n, max(3 - trial, 1), off=-off,
                    rbs=a.row_block_sizes)
        with config_override(mm_driver="band"):
            c_band = dt.multiply("N", "N", 1.0, a, b)
        with config_override(mm_driver="stack"):
            c_stack = dt.multiply("N", "N", 1.0, a, b)
        np.testing.assert_allclose(
            dense(c_band), dense(c_stack), atol=1e-11
        )
