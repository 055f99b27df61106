"""Device-resident filtered executor (mm/filtered.py) vs the host-planned
filtered multiply.

The equivalence being pinned (see the module docstring's Cauchy-Schwarz
argument): superset product + final eps filter on device == the engine's
``filter_mode="sum"`` host path — identical kept pattern, identical values
on kept blocks. Plus: data may change every call with NO host replanning
(the linear-scaling SCF loop), and the keep decision is genuinely
data-dependent.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dbcsr_tpu as dt


def _decayed_pair(rng, n=60, eps_scale=True):
    """Banded operands with off-diagonal magnitude decay, so the eps
    filter genuinely truncates the product tail (the SCF density-matrix
    shape used by the filtered bench)."""
    rbs = dt.random_block_sizes(n, [2, 3, 5], rng)
    a = dt.random_matrix(rbs, rbs, 0.5, rng, dtype=np.float32, name="A")
    b = dt.random_matrix(rbs, rbs, 0.5, rng, dtype=np.float32, name="B")

    def decay(m, rate):
        from dbcsr_tpu.block.tileops import coord_mask

        lay = m.layout
        offs = np.concatenate(
            ([0], np.cumsum(m.index.row_block_sizes.astype(np.int64)))
        )
        nelem = int(offs[-1])

        def f(r, c):
            br = jnp.searchsorted(jnp.asarray(offs), r, side="right") - 1
            bc = jnp.searchsorted(jnp.asarray(offs), c, side="right") - 1
            return jnp.exp(-rate * jnp.abs(br - bc).astype(jnp.float32))

        from dataclasses import replace

        return replace(m, data=m.data * coord_mask(lay, f).astype(m.dtype))

    return decay(a, 0.8), decay(b, 0.8)


def _pattern(m):
    return set(zip(m.index.blk_rows.tolist(), m.index.col_idx.tolist()))


@pytest.mark.parametrize("transa,transb", [("N", "N"), ("T", "N"), ("N", "T")])
def test_matches_host_filtered_multiply(rng, transa, transb):
    a, b = _decayed_pair(rng)
    eps = 3e-2
    ref = dt.multiply(transa, transb, 1.0, a, b, filter_eps=eps)

    ex = dt.build_filtered_executor(transa, transb, a, b, eps)
    c_data, keep, nsq = ex.step(a.data, b.data)
    got = ex.compact(c_data, keep)

    assert _pattern(got) == _pattern(ref)
    assert np.allclose(
        np.asarray(got.to_dense()), np.asarray(ref.to_dense()),
        rtol=0, atol=1e-6,
    )
    # something must actually have been filtered for the test to mean
    # anything, and the superset must be a strict superset
    assert 0 < got.nblks < ex.c_index.nblks
    kf = ex.kept_flops(keep)
    assert 0.0 < kf <= ex.eff_flops


def test_step_is_data_varying_and_replans_nothing(rng):
    """Same executor, three different data contents: keep sets differ,
    each result matches the host path for THAT data — the per-call work
    is pure device compute (no symbolic replan is even reachable from
    step())."""
    a, b = _decayed_pair(rng)
    eps = 3e-2
    ex = dt.build_filtered_executor("N", "N", a, b, eps)

    keeps = []
    from dataclasses import replace

    for scale in (1.0, 0.31, 4.0):
        # scaling changes which blocks clear eps (norms scale by s²)
        a_s = replace(a, data=a.data * np.float32(scale))
        c_data, keep, _ = ex.step(a_s.data, b.data)
        got = ex.compact(c_data, keep)
        ref = dt.multiply("N", "N", 1.0, a_s, b, filter_eps=eps)
        assert _pattern(got) == _pattern(ref)
        assert np.allclose(
            np.asarray(got.to_dense()), np.asarray(ref.to_dense()),
            rtol=0, atol=1e-6,
        )
        keeps.append(np.asarray(keep).astype(bool))
    assert not np.array_equal(keeps[0], keeps[1])
    assert not np.array_equal(keeps[0], keeps[2])


def test_step_composes_under_jit_scan(rng):
    """The SCF-loop form: the step runs inside jit/scan with a
    loop-carried dependency (C feeds the next A), zero host interaction
    per iteration. The superset store layout of C must equal A's for the
    chaining to typecheck — use a square banded pattern whose product
    pattern re-tiles onto itself."""
    rbs = np.full(24, 5, dtype=np.int32)
    n = len(rbs)
    i = np.repeat(np.arange(n, dtype=np.int64), 5)
    j = i + np.tile(np.arange(-2, 3, dtype=np.int64), n)
    keepm = (j >= 0) & (j < n)
    from dbcsr_tpu.block.bcsr import BCSRMatrix
    from dbcsr_tpu.block.index import build_index
    from dbcsr_tpu.block.store import store_layout
    from dbcsr_tpu.block.tileops import valid_mask

    idx, _ = build_index(i[keepm], j[keepm], rbs, rbs)
    lay = store_layout(idx, 128)
    data = jax.random.normal(
        jax.random.PRNGKey(0), (lay.n_tiles, 128, 128), jnp.float32
    ) * valid_mask(idx, 128) * 0.05
    a = BCSRMatrix(name="A", index=idx, data=data)
    ex = dt.build_filtered_executor("N", "N", a, a, 1e-4)
    sup_lay = store_layout(ex.c_index, 128)

    if not np.array_equal(sup_lay.tile_keys(), lay.tile_keys()):
        pytest.skip("product superset does not re-tile onto A's layout")

    @jax.jit
    def loop(a0, b0):
        def body(carry, _):
            c, k, _n = ex.step(carry, b0)
            return c, jnp.sum(k)

        return jax.lax.scan(body, a0, None, length=3)

    final, kept_counts = loop(a.data, a.data)
    assert final.shape == a.data.shape
    counts = np.asarray(kept_counts)
    assert (counts > 0).all()


def test_rejects_zero_eps(rng):
    a, b = _decayed_pair(rng, n=10)
    from dbcsr_tpu.core.errors import DbcsrError

    with pytest.raises(Exception):
        dt.build_filtered_executor("N", "N", a, b, 0.0)
