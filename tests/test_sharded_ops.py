"""Sharded elementwise / reduction / pattern-changing ops (v3): every op
acts directly on owner-sharded stores and agrees with the local ops layer
(which itself is validated against dense oracles)."""
import numpy as np
import pytest

import jax

import dbcsr_tpu as dt
from dbcsr_tpu.core.config import config_override
from dbcsr_tpu.dist.distribution import tile_aligned_dist
from dbcsr_tpu.dist.grid import ProcessGrid
from dbcsr_tpu.dist.sharded_ops import (
    build_sharded_add,
    shard_matrix,
    sharded_add,
    sharded_block_norms,
    sharded_dot,
    sharded_filter,
    sharded_frobenius,
    sharded_function_of_elements,
    sharded_hadamard,
    sharded_maxabs,
    sharded_scale,
    sharded_scale_by_vector,
    sharded_trace,
)
from dbcsr_tpu.ops.arithmetic import (
    add,
    dot,
    filter_blocks,
    hadamard_product,
    scale_by_vector,
    trace,
)
from dbcsr_tpu.ops.norms import block_norms_sq, norm_frobenius, norm_maxabs

TILE = 8


def _pair(rng, occ_a=0.4, occ_b=0.4, square=True):
    with config_override(tile_size=TILE):
        rbs = dt.random_block_sizes(72, [2, 4], rng)
        cbs = rbs if square else dt.random_block_sizes(56, [2], rng)
        a = dt.random_matrix(rbs, cbs, occ_a, rng, dtype=np.float32, name="A")
        b = dt.random_matrix(rbs, cbs, occ_b, rng, dtype=np.float32, name="B")
    grid = ProcessGrid.make(2, 2)
    dist = tile_aligned_dist(grid, rbs, cbs, TILE)
    return a, b, dist


def _dense(sm):
    return np.asarray(sm.to_local().to_dense())


def test_shard_matrix_roundtrip(rng):
    a, _, dist = _pair(rng)
    sa = shard_matrix(a, dist)
    back = sa.to_local()
    np.testing.assert_array_equal(
        np.asarray(back.to_dense()), np.asarray(a.to_dense())
    )
    # data really is owner-partitioned across all 4 devices
    assert len({s.device for s in sa.data.addressable_shards}) == 4


def test_sharded_add_union_pattern(rng):
    a, b, dist = _pair(rng, 0.3, 0.3)
    sa, sb = shard_matrix(a, dist), shard_matrix(b, dist)
    sc = sharded_add(1.5, sa, -0.5, sb)
    ref = add(1.5, a, -0.5, b)
    assert sc.index.nblks == ref.index.nblks
    np.testing.assert_allclose(
        _dense(sc), np.asarray(ref.to_dense()), rtol=1e-6, atol=1e-6
    )
    # result stays sharded by owner
    assert len({s.device for s in sc.data.addressable_shards}) == 4


def test_sharded_add_jitted_closure(rng):
    a, b, dist = _pair(rng, 0.5, 0.5)
    sa, sb = shard_matrix(a, dist), shard_matrix(b, dist)
    c_index, c_sl, fn = build_sharded_add(sa, sb)
    out = jax.jit(fn)(sa.data, sb.data, 2.0, 3.0)
    ref = add(2.0, a, 3.0, b)
    from dbcsr_tpu.dist.sharded import unshard_store_with_layout

    back = unshard_store_with_layout(out, c_sl, TILE)
    c = dt.BCSRMatrix(name="c", index=c_index, data=back)
    np.testing.assert_allclose(
        np.asarray(c.to_dense()), np.asarray(ref.to_dense()),
        rtol=1e-6, atol=1e-6,
    )


def test_sharded_hadamard_intersection(rng):
    a, b, dist = _pair(rng, 0.5, 0.5)
    sa, sb = shard_matrix(a, dist), shard_matrix(b, dist)
    sc = sharded_hadamard(sa, sb)
    ref = hadamard_product(a, b)
    assert sc.index.nblks == ref.index.nblks
    np.testing.assert_allclose(
        _dense(sc), np.asarray(ref.to_dense()), rtol=1e-6, atol=1e-6
    )


def test_sharded_scale_and_function(rng):
    a, _, dist = _pair(rng)
    sa = shard_matrix(a, dist)
    np.testing.assert_allclose(
        _dense(sharded_scale(sa, -2.0)), -2.0 * np.asarray(a.to_dense()),
        rtol=1e-6,
    )
    sf = sharded_function_of_elements(sa, "exp")
    ref = np.asarray(a.to_dense())
    vm = np.asarray(a.to_dense()) != 0  # exp only on stored positions
    expect = np.where(vm, np.exp(ref), 0.0)
    got = _dense(sf)
    # padding inside stored blocks: compare through the local op instead
    from dbcsr_tpu.ops.arithmetic import function_of_elements

    np.testing.assert_allclose(
        got, np.asarray(function_of_elements(a, "exp").to_dense()),
        rtol=1e-6, atol=1e-6,
    )
    assert expect.shape == got.shape


@pytest.mark.parametrize("side", ["left", "right"])
def test_sharded_scale_by_vector(rng, side):
    a, _, dist = _pair(rng, square=False)
    sa = shard_matrix(a, dist)
    n = a.index.nfullrows if side == "left" else a.index.nfullcols
    v = rng.standard_normal(n).astype(np.float32)
    got = sharded_scale_by_vector(sa, v, side)
    ref = scale_by_vector(a, v, side)
    np.testing.assert_allclose(
        _dense(got), np.asarray(ref.to_dense()), rtol=1e-5, atol=1e-5
    )


def test_sharded_reductions(rng):
    a, b, dist = _pair(rng)
    sa, sb = shard_matrix(a, dist), shard_matrix(b, dist)
    assert sharded_trace(sa) == pytest.approx(trace(a), rel=1e-5)
    assert sharded_dot(sa, sb) == pytest.approx(dot(a, b), rel=1e-5)
    assert sharded_frobenius(sa) == pytest.approx(norm_frobenius(a), rel=1e-5)
    assert sharded_maxabs(sa) == pytest.approx(norm_maxabs(a), rel=1e-6)


def test_sharded_block_norms_and_filter(rng):
    a, _, dist = _pair(rng)
    sa = shard_matrix(a, dist)
    np.testing.assert_allclose(
        sharded_block_norms(sa), np.asarray(block_norms_sq(a)),
        rtol=1e-5, atol=1e-6,
    )
    eps = float(np.sqrt(np.median(sharded_block_norms(sa))))
    got = sharded_filter(sa, eps)
    ref = filter_blocks(a, eps)
    assert got.index.nblks == ref.index.nblks
    np.testing.assert_allclose(
        _dense(got), np.asarray(ref.to_dense()), rtol=1e-6, atol=1e-6
    )
    # filtered result still owner-sharded, pattern actually shrank
    assert got.index.nblks < a.index.nblks


@pytest.mark.parametrize("transa,transb", [("N", "N"), ("T", "N")])
def test_sharded_multiply_first_class(rng, transa, transb):
    """sharded_multiply on ShardedMatrix operands: at-rest owner layouts
    (from the plain dist) are resharded onto the executor's k-binned panel
    layouts inside jit."""
    from dbcsr_tpu.dist.sharded_ops import sharded_multiply

    grid = ProcessGrid.make(2, 2)
    with config_override(tile_size=TILE):
        rbs = dt.random_block_sizes(72, [2, 4], rng)
        kbs = dt.random_block_sizes(64, [4], rng)
        cbs = dt.random_block_sizes(56, [2], rng)
        a_shape = (rbs, kbs) if transa == "N" else (kbs, rbs)
        a = dt.random_matrix(*a_shape, 0.4, rng, dtype=np.float32)
        b = dt.random_matrix(kbs, cbs, 0.4, rng, dtype=np.float32)
        dist = tile_aligned_dist(grid, rbs, cbs, TILE)
        dist_a = tile_aligned_dist(grid, a_shape[0], a_shape[1], TILE)
        dist_b = tile_aligned_dist(grid, kbs, cbs, TILE)
        sa0 = shard_matrix(a, dist_a)
        sb = shard_matrix(b, dist_b)
        # operands carry their own at-rest layouts; the product's dist (C's
        # m x n decomposition) comes from sa.dist
        from dbcsr_tpu.dist.sharded_ops import ShardedMatrix

        sa = ShardedMatrix(
            name=sa0.name, index=sa0.index, tile=TILE, dist=dist,
            shard=sa0.shard, data=sa0.data,
        )
        sc = sharded_multiply(transa, transb, 2.0, sa, sb)
    da = np.asarray(a.to_dense())
    if transa == "T":
        da = da.T
    ref = 2.0 * da @ np.asarray(b.to_dense())
    np.testing.assert_allclose(
        _dense(sc), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max()
    )


def test_sharded_multiply_beta_c(rng):
    from dbcsr_tpu.dist.sharded_ops import sharded_multiply

    grid = ProcessGrid.make(2, 2)
    with config_override(tile_size=TILE):
        rbs = dt.random_block_sizes(64, [4], rng)
        a = dt.random_matrix(rbs, rbs, 0.5, rng, dtype=np.float32)
        b = dt.random_matrix(rbs, rbs, 0.5, rng, dtype=np.float32)
        c0 = dt.random_matrix(rbs, rbs, 0.3, rng, dtype=np.float32)
        dist = tile_aligned_dist(grid, rbs, rbs, TILE)
        sa, sb, sc0 = (shard_matrix(m, dist) for m in (a, b, c0))
        out = sharded_multiply("N", "N", 1.0, sa, sb, beta=0.5, c=sc0)
    ref = np.asarray(a.to_dense()) @ np.asarray(b.to_dense()) + 0.5 * np.asarray(
        c0.to_dense()
    )
    np.testing.assert_allclose(
        _dense(out), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max()
    )


def test_sharded_checkpoint_roundtrip(rng, tmp_path):
    """Per-shard checkpoint write/read without gathering (the MPI-IO
    analog for owner-sharded storage)."""
    from dbcsr_tpu.dist.sharded_ops import (
        sharded_checkpoint_read,
        sharded_checkpoint_write,
    )

    a, _, dist = _pair(rng)
    sa = shard_matrix(a, dist)
    d = str(tmp_path / "ckpt")
    sharded_checkpoint_write(sa, d)
    import os

    assert os.path.exists(os.path.join(d, "index.npz"))
    assert os.path.exists(os.path.join(d, "shard_3.npy"))
    back = sharded_checkpoint_read(d, dist.grid)
    assert back.nblks == sa.nblks and back.tile == sa.tile
    np.testing.assert_array_equal(_dense(back), np.asarray(a.to_dense()))
    # restored data is owner-sharded, usable directly by sharded ops
    assert sharded_trace(back) == pytest.approx(trace(a), rel=1e-5)


def test_sharded_ops_complex(rng):
    """Complex dtype through the sharded elementwise/reduction layer
    (native on complex-capable backends, split-complex emulated where
    forced — both paths green;
    conjugation in dot, complex block norms in filter)."""
    grid = ProcessGrid.make(2, 2)
    with config_override(tile_size=TILE):
        rbs = dt.random_block_sizes(48, [2, 4], rng)
        a = dt.random_matrix(rbs, rbs, 0.5, rng, dtype=np.complex64)
        b = dt.random_matrix(rbs, rbs, 0.5, rng, dtype=np.complex64)
    dist = tile_aligned_dist(grid, rbs, rbs, TILE)
    sa, sb = shard_matrix(a, dist), shard_matrix(b, dist)
    sc = sharded_add(1 + 1j, sa, 0.5j, sb)
    ref = add(1 + 1j, a, 0.5j, b)
    np.testing.assert_allclose(
        _dense(sc), np.asarray(ref.to_dense()), rtol=1e-5, atol=1e-5
    )
    assert sharded_dot(sa, sb) == pytest.approx(dot(a, b), rel=1e-5)
    assert sharded_trace(sa) == pytest.approx(trace(a), rel=1e-5)
    np.testing.assert_allclose(
        sharded_block_norms(sa), np.asarray(block_norms_sq(a)),
        rtol=1e-5, atol=1e-6,
    )
    eps = float(np.sqrt(np.median(sharded_block_norms(sa))))
    got = sharded_filter(sa, eps)
    reff = filter_blocks(a, eps)
    assert got.index.nblks == reff.index.nblks
    np.testing.assert_allclose(
        _dense(got), np.asarray(reff.to_dense()), rtol=1e-5, atol=1e-5
    )


def test_sharded_iteration_mixing_mm_and_ops(rng):
    """The full v3 loop: multiply + union-add + filter, never unsharding
    (the linear-scaling-SCF shape on sharded storage)."""
    from dbcsr_tpu.dist.sharded import shard_store_with_layout
    from dbcsr_tpu.dist.sharded_ops import ShardedMatrix
    from dbcsr_tpu.mm.engine import build_distributed_executor

    grid = ProcessGrid.make(2, 2)
    with config_override(tile_size=TILE):
        rbs = dt.random_block_sizes(48, [4], rng)
        a = dt.random_matrix(rbs, rbs, 1.0, rng, dtype=np.float32)
        dist = tile_aligned_dist(grid, rbs, rbs, TILE)
        fn, c_index, _ = build_distributed_executor(
            "N", "N", a, a, dist, sharded=True
        )
        a_sh = shard_store_with_layout(a, fn.shard_a, grid.mesh)
        sq_data = jax.jit(fn)(a_sh, a_sh)
        sq = ShardedMatrix(
            name="A2", index=c_index, tile=TILE, dist=dist,
            shard=fn.shard_c, data=sq_data,
        )
        sa = ShardedMatrix(
            name="A", index=a.index, tile=TILE, dist=dist,
            shard=fn.shard_a, data=a_sh,
        )
        mixed = sharded_add(1.0, sq, -0.5, sa)      # A² - A/2, sharded
        out = sharded_filter(mixed, 1e-30)          # no-op filter path
    ref = np.asarray(a.to_dense())
    expect = ref @ ref - 0.5 * ref
    np.testing.assert_allclose(
        _dense(out), expect, rtol=1e-4, atol=1e-4 * np.abs(expect).max()
    )


def test_sharded_ops_complex_emulated(rng, tmp_path):
    """The full complex sharded surface under FORCED split-complex
    emulation: multiply, add/scale/hadamard, reductions,
    filter, checkpoint roundtrip — round 2, z/c first-class on sharded
    storage too."""
    import jax as _jax

    from dbcsr_tpu.core import machine
    from dbcsr_tpu.dist.sharded_ops import (
        sharded_checkpoint_read,
        sharded_checkpoint_write,
        sharded_filter,
        sharded_frobenius,
        sharded_hadamard,
        sharded_maxabs,
        sharded_multiply,
        sharded_scale,
    )
    from dbcsr_tpu.ops.norms import norm_frobenius, norm_maxabs

    key = _jax.devices()[0].platform
    old = dict(machine._COMPLEX_OK)
    machine._COMPLEX_OK[key] = False
    try:
        grid = ProcessGrid.make(2, 2)
        with config_override(tile_size=TILE):
            rbs = dt.random_block_sizes(48, [2, 4], rng)
            a = dt.random_matrix(rbs, rbs, 0.5, rng, dtype=np.complex128)
            b = dt.random_matrix(rbs, rbs, 0.5, rng, dtype=np.complex128)
            assert a.is_complex_emulated
            dist = tile_aligned_dist(grid, rbs, rbs, TILE)
            sa, sb = shard_matrix(a, dist), shard_matrix(b, dist)
            assert sa.is_complex_emulated

            sc = sharded_add(1 + 1j, sa, 0.5j, sb)
            ref = add(1 + 1j, a, 0.5j, b)
            np.testing.assert_allclose(
                _dense(sc), np.asarray(ref.to_dense()), atol=1e-10
            )
            assert sharded_dot(sa, sb) == pytest.approx(dot(a, b), rel=1e-10)
            assert sharded_trace(sa) == pytest.approx(trace(a), rel=1e-10)
            assert sharded_frobenius(sa) == pytest.approx(
                norm_frobenius(a), rel=1e-6
            )
            assert sharded_maxabs(sa) == pytest.approx(
                norm_maxabs(a), rel=1e-6
            )
            sh = sharded_hadamard(sa, sb)
            np.testing.assert_allclose(
                _dense(sh),
                np.asarray(a.to_dense()) * np.asarray(b.to_dense()),
                atol=1e-10,
            )
            ss = sharded_scale(sa, 2.0 - 1.0j)
            np.testing.assert_allclose(
                _dense(ss), (2.0 - 1.0j) * np.asarray(a.to_dense()),
                atol=1e-12,
            )
            sm = sharded_multiply("C", "N", 1.0 + 0.5j, sa, sb)
            refm = (1.0 + 0.5j) * (
                np.asarray(a.to_dense()).conj().T @ np.asarray(b.to_dense())
            )
            np.testing.assert_allclose(_dense(sm), refm, atol=1e-10)
            sf = sharded_filter(sharded_scale(sa, 1e-3), 1e-2)
            assert sf.nblks <= sa.nblks
            # checkpoint roundtrip keeps the emulated complex content
            d = str(tmp_path / "ck")
            sharded_checkpoint_write(sa, d)
            back = sharded_checkpoint_read(d, dist.grid)
            assert back.is_complex_emulated
            np.testing.assert_allclose(_dense(back), np.asarray(a.to_dense()))
    finally:
        machine._COMPLEX_OK.clear()
        machine._COMPLEX_OK.update(old)


def test_sharded_ops_25d_grid(rng, tmp_path):
    """At-rest sharded storage on the 2.5D (2x2x2) mesh (round-2 VERDICT
    item 7): the owner partition lives on the (pr, pc) plane with the tile
    data replicated across the layer axis, and everything composes — the
    layered multiply executor, the owner-local elementwise ops, the scalar
    reductions, filter, and the per-shard checkpoint. Reference analog:
    the 3D driver over 2-D-distributed storage
    (``/root/reference/src/mm/dbcsr_mm_3d.F:1038-1136``)."""
    from dbcsr_tpu.dist.sharded_ops import (
        sharded_checkpoint_read,
        sharded_checkpoint_write,
        sharded_multiply,
    )

    grid = ProcessGrid.make(2, 2, nlayer=2)
    with config_override(tile_size=TILE):
        rbs = dt.random_block_sizes(64, [4], rng)
        a = dt.random_matrix(rbs, rbs, 0.5, rng, dtype=np.float32, name="A")
        b = dt.random_matrix(rbs, rbs, 0.5, rng, dtype=np.float32, name="B")
        dist = tile_aligned_dist(grid, rbs, rbs, TILE)
        sa = shard_matrix(a, dist)
        sb = shard_matrix(b, dist)
        ad, bd = np.asarray(a.to_dense()), np.asarray(b.to_dense())

        # roundtrip + owner partition on the plane (4 owners, 8 devices)
        np.testing.assert_array_equal(_dense(sa), ad)
        assert len({s.device for s in sa.data.addressable_shards}) == 8
        assert sa.shard.ndev == 4

        # layered multiply executor straight off the at-rest stores
        sc = sharded_multiply("N", "N", 1.0, sa, sb)
        ref = ad @ bd
        np.testing.assert_allclose(
            _dense(sc), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max()
        )

        # owner-local elementwise + pattern-changing ops
        ssum = sharded_add(1.0, sa, -0.5, sa)
        np.testing.assert_allclose(_dense(ssum), 0.5 * ad, atol=1e-6)
        sh = sharded_hadamard(sa, sb)
        np.testing.assert_allclose(_dense(sh), ad * bd, atol=1e-5)
        sf = sharded_filter(sharded_scale(sa, 1e-3), 1e-2)
        assert sf.nblks <= sa.nblks

        # scalar reductions
        assert sharded_frobenius(sa) == pytest.approx(
            float(np.linalg.norm(ad)), rel=1e-5
        )
        assert sharded_trace(sa) == pytest.approx(
            float(np.trace(ad)), rel=1e-4, abs=1e-3
        )

        # per-shard checkpoint: one file per PLANE owner (no layer dupes)
        d = str(tmp_path / "ckpt25d")
        sharded_checkpoint_write(sa, d)
        import glob
        import os

        assert len(glob.glob(os.path.join(d, "shard_*.npy"))) == 4
        back = sharded_checkpoint_read(d, grid)
        np.testing.assert_array_equal(_dense(back), ad)


def test_sharded_multiply_plan_cached(rng):
    """One-shot sharded_multiply reuses the content-keyed plan cache
    (the local engine's iterative-caller amortization, mm/plancache.py):
    second call with the same operands plans nothing, different
    transposes get their own plan."""
    from dbcsr_tpu.dist.sharded_ops import sharded_multiply
    from dbcsr_tpu.mm.plancache import get_plan_cache

    a, b, dist = _pair(rng)
    sa, sb = shard_matrix(a, dist), shard_matrix(b, dist)
    pc = get_plan_cache()
    h0, m0 = pc.hits, pc.misses
    c1 = sharded_multiply("N", "N", 1.0, sa, sb)
    c2 = sharded_multiply("N", "N", 1.0, sa, sb)
    assert pc.hits - h0 == 1 and pc.misses - m0 == 1
    np.testing.assert_array_equal(_dense(c1), _dense(c2))
    ref = np.asarray(a.to_dense()) @ np.asarray(b.to_dense())
    np.testing.assert_allclose(
        _dense(c1), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max()
    )
    ct = sharded_multiply("T", "N", 1.0, sa, sb)
    reft = np.asarray(a.to_dense()).T @ np.asarray(b.to_dense())
    np.testing.assert_allclose(
        _dense(ct), reft, rtol=1e-4, atol=1e-4 * np.abs(reft).max()
    )
