"""Plan cache: repeated unfiltered multiplies over identical patterns must
hit the cache and return identical results."""
import numpy as np

import dbcsr_tpu as dt
from dbcsr_tpu.mm.plancache import get_plan_cache, index_fingerprint


def test_fingerprint_stability_and_content(rng):
    bs = dt.random_block_sizes(20, [2, 3], rng)
    a = dt.random_matrix(bs, bs, 0.5, rng, dtype=np.float64)
    f1 = index_fingerprint(a.index)
    assert f1 == index_fingerprint(a.index)
    # same content, different object -> same fingerprint
    b = dt.BCSRMatrix.from_flat(a.index, a.flat_host(), name="b")
    assert index_fingerprint(b.index) == f1
    # different pattern -> different fingerprint
    c = dt.random_matrix(bs, bs, 0.3, rng, dtype=np.float64)
    assert index_fingerprint(c.index) != f1


def test_multiply_hits_cache(rng):
    cache = get_plan_cache()
    cache.clear()
    bs = dt.random_block_sizes(30, [2, 3], rng)
    a = dt.random_matrix(bs, bs, 0.4, rng, dtype=np.float64)
    b = dt.random_matrix(bs, bs, 0.4, rng, dtype=np.float64)
    c1 = dt.multiply("N", "N", 1.0, a, b)
    misses0 = cache.misses
    c2 = dt.multiply("N", "N", 1.0, a.with_data(a.data * 2.0), b)
    assert cache.hits >= 1 and cache.misses == misses0
    np.testing.assert_allclose(
        np.asarray(c2.to_dense()), 2.0 * np.asarray(c1.to_dense()), atol=1e-10
    )


def test_filtered_multiply_norms_never_stale_cached(rng):
    """The norms-dependent SYMBOLIC plan of a filtered multiply is never
    cached (the surviving pattern depends on data), while pattern-derived
    pieces (built product index, tile plan, mnk stats) ARE content-cached
    across identical calls (round-4: per-call host cost of the
    linear-scaling SCF loop). Correctness criterion: changing the data
    changes the filtered result — no stale pattern reuse."""
    cache = get_plan_cache()
    cache.clear()
    bs = dt.random_block_sizes(20, [2, 3], rng)
    a = dt.random_matrix(bs, bs, 0.4, rng, dtype=np.float64)
    b = dt.random_matrix(bs, bs, 0.4, rng, dtype=np.float64)
    c1 = dt.multiply("N", "N", 1.0, a, b, filter_eps=1e-3)
    c2 = dt.multiply("N", "N", 1.0, a, b, filter_eps=1e-3)
    # identical call: pattern-derived caches may hit, result identical
    np.testing.assert_array_equal(
        np.asarray(c1.to_dense()), np.asarray(c2.to_dense())
    )
    # the unfiltered-symbolic cache entry is never consulted: scaling the
    # data changes which blocks survive eps, and the result tracks it
    tiny = a.with_data(a.data * 1e-6)
    c3 = dt.multiply("N", "N", 1.0, tiny, b, filter_eps=1e-3)
    assert c3.nblks < c1.nblks
    ref = np.asarray(tiny.to_dense()) @ np.asarray(b.to_dense())
    got = np.asarray(c3.to_dense())
    # surviving blocks match the true product
    mask = got != 0
    np.testing.assert_allclose(got[mask], ref[mask], atol=1e-12)


def test_distributed_multiply_hits_plan_cache(rng):
    """Second same-pattern distributed multiply skips Cannon planning
    (round-2 criterion: content-keyed cache inside multiply(dist=...))."""
    from dbcsr_tpu.dist import Distribution, ProcessGrid, tile_aligned_dist

    cache = get_plan_cache()
    cache.clear()
    grid = ProcessGrid.make(2, 2)
    bs = dt.random_block_sizes(24, [3, 5], rng)
    dist = tile_aligned_dist(grid, bs, bs, 128)
    a = dt.random_matrix(bs, bs, 0.5, rng, dtype=np.float32)
    b = dt.random_matrix(bs, bs, 0.5, rng, dtype=np.float32)
    c1 = dt.multiply("N", "N", 1.0, a, b, dist=dist)
    h0, m0 = cache.hits, cache.misses
    c2 = dt.multiply("N", "N", 1.0, a.with_data(a.data * 3.0), b, dist=dist)
    # every plan lookup of the second call must hit (symbolic + cannon)
    assert cache.misses == m0 and cache.hits > h0
    np.testing.assert_allclose(
        np.asarray(c2.to_dense()), 3.0 * np.asarray(c1.to_dense()),
        atol=1e-4,
    )


def test_summa_hits_plan_cache(rng):
    from dbcsr_tpu.dist import Distribution, ProcessGrid, tile_aligned_dist

    cache = get_plan_cache()
    cache.clear()
    grid = ProcessGrid.make(2, 4)
    bs = dt.random_block_sizes(24, [3, 5], rng)
    dist = tile_aligned_dist(grid, bs, bs, 128)
    a = dt.random_matrix(bs, bs, 0.5, rng, dtype=np.float32)
    b = dt.random_matrix(bs, bs, 0.5, rng, dtype=np.float32)
    dt.multiply("N", "N", 1.0, a, b, dist=dist)
    m0 = cache.misses
    dt.multiply("N", "N", 1.0, a, b, dist=dist)
    assert cache.misses == m0
