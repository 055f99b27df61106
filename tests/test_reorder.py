"""Locality reordering (mm/reorder.py): RCM renumbering recovers the
hidden band of clustered-but-scrambled patterns, and the permuted plan
computes the same product (slot-exact after key mapping)."""
import numpy as np
import pytest

from dbcsr_tpu.mm.reorder import locality_reorder_plan, tile_bandwidth
from dbcsr_tpu.mm.tileplan import plan_tile_stacks_stores


def _scrambled_band_pair(n, w, seed=0):
    """Banded A and B tile patterns |i-j|<=w whose labels are scrambled
    by three hidden permutations (m, k, n axes) — A's col scramble IS
    B's row scramble, so the product pattern is a scrambled band too
    (the hidden-locality shape RCM must recover)."""
    rng = np.random.default_rng(seed)
    i = np.repeat(np.arange(n, dtype=np.int64), 2 * w + 1)
    j = i + np.tile(np.arange(-w, w + 1, dtype=np.int64), n)
    keep = (j >= 0) & (j < n)
    i, j = i[keep], j[keep]
    sig_m, sig_k, sig_n = (
        rng.permutation(n).astype(np.int64) for _ in range(3)
    )

    def scramble(sr, sc):
        coords = np.stack([sr[i], sc[j]], axis=1)
        order = np.argsort(coords[:, 0] * n + coords[:, 1])
        return coords[order]

    return scramble(sig_m, sig_k), scramble(sig_k, sig_n)


def _stack_product(plan, a_st, b_st):
    t = a_st.shape[1]
    out = np.zeros((plan.n_c_tiles, t, t))
    for c, ai, bi in plan.stack:
        out[c] += a_st[ai] @ b_st[bi]
    return out


def test_reorder_recovers_panel_admissibility():
    """A scrambled band spans the whole tile grid; the RCM renumbering
    brings every operand back within a narrow band (the locality a
    C-window of consecutive tiles needs), bijectively."""
    n, w = 96, 3
    a_coords, b_coords = _scrambled_band_pair(n, w, seed=1)
    nat = plan_tile_stacks_stores(a_coords, (n, n), b_coords, (n, n))
    assert tile_bandwidth(a_coords) > n // 2  # scrambled

    rp = locality_reorder_plan(a_coords, (n, n), b_coords, (n, n))
    assert rp is not None
    rplan = plan_tile_stacks_stores(rp.a_coords, (n, n), rp.b_coords, (n, n))
    assert len(rplan.stack) == len(nat.stack)  # bijective renumbering
    assert tile_bandwidth(rp.a_coords) <= 4 * w
    assert tile_bandwidth(rp.b_coords) <= 4 * w
    for p in (rp.pm, rp.pk, rp.pn):
        assert np.array_equal(np.sort(p), np.arange(n))


@pytest.mark.parametrize("shape", [(40, 32, 24), (48, 48, 48)])
def test_reorder_product_equivalence(shape):
    """Permuted-plan product == natural-plan product after mapping the
    permuted C keys back (exact: same set of tile triples)."""
    mt, kt, nt = shape
    rng = np.random.default_rng(7)
    t = 4

    def rand_coords(nr, nc, p):
        mask = rng.random((nr, nc)) < p
        r, c = np.nonzero(mask)
        return np.stack([r, c], axis=1).astype(np.int64)

    a_coords = rand_coords(mt, kt, 0.3)
    b_coords = rand_coords(kt, nt, 0.3)
    a_st = rng.standard_normal((len(a_coords), t, t))
    b_st = rng.standard_normal((len(b_coords), t, t))

    nat = plan_tile_stacks_stores(a_coords, (mt, kt), b_coords, (kt, nt))
    c_nat = _stack_product(nat, a_st, b_st)

    rp = locality_reorder_plan(a_coords, (mt, kt), b_coords, (kt, nt))
    assert rp is not None
    rplan = plan_tile_stacks_stores(
        rp.a_coords, (mt, kt), rp.b_coords, (kt, nt)
    )
    c_perm = _stack_product(rplan, a_st[rp.a_gather], b_st[rp.b_gather])

    # map each natural C slot to its permuted slot via the key mapping
    perm_keys = rp.c_slot_keys(nat.c_tile_keys, nt)
    slot_of = {k: s for s, k in enumerate(rplan.c_tile_keys)}
    for s_nat, k in enumerate(perm_keys):
        np.testing.assert_allclose(
            c_nat[s_nat], c_perm[slot_of[int(k)]], atol=1e-12
        )


def test_reorder_degenerate_inputs():
    z = np.zeros((0, 2), dtype=np.int64)
    assert locality_reorder_plan(z, (4, 4), z, (4, 4)) is None
    tiny = np.array([[0, 0]], dtype=np.int64)
    assert locality_reorder_plan(tiny, (2, 2), tiny, (2, 2)) is None


def test_executor_reorder_end_to_end():
    """A clustered-but-scrambled block matrix, renumbered once with
    ``locality_block_permutation``/``permute_blocks``, through the
    plan-once executor: the product matches the dense oracle of the
    permuted operands and its tile count shrinks."""
    import dbcsr_tpu as dt
    from dbcsr_tpu.block.bcsr import BCSRMatrix
    from dbcsr_tpu.core.config import config_override
    from dbcsr_tpu.mm.engine import build_multiply_executor

    n, w = 96, 3
    a_coords, b_coords = _scrambled_band_pair(n, w, seed=3)
    rng = np.random.default_rng(5)

    def mat(coords, name):
        b = dt.BCSRBuilder([8] * n, [8] * n, name=name, dtype=np.float32)
        for r, c in coords:
            b.put_block(int(r), int(c), rng.standard_normal((8, 8)))
        return b.finalize()

    with config_override(tile_size=16):
        a = mat(a_coords, "A")
        b = mat(b_coords, "B")
        pm, pk, pn = dt.locality_block_permutation(a.index, b.index)
        ar = dt.permute_blocks(a, pm, pk)
        br = dt.permute_blocks(b, pk, pn)
        assert ar.layout.n_tiles < a.layout.n_tiles
        ref = np.asarray(ar.to_dense()) @ np.asarray(br.to_dense())
        fn, c_index, _ = build_multiply_executor("N", "N", ar, br)
        out = fn(ar.data, br.data)
    c = BCSRMatrix(name="C", index=c_index, data=out)
    np.testing.assert_allclose(np.asarray(c.to_dense()), ref, atol=1e-3)


def test_block_permutation_roundtrip_and_recovery():
    """permute_blocks moves blocks+sizes correctly (dense equality), and
    locality_block_permutation recovers tile-packing density on a
    clustered-but-scrambled block numbering."""
    import dbcsr_tpu as dt

    rng = np.random.default_rng(11)
    n = 400
    sizes = rng.choice([3, 5, 8], size=n).astype(np.int32)
    # hidden 1-D chain with exponential-decay coupling, then scramble
    dmax = 9
    i = np.repeat(np.arange(n, dtype=np.int64), 2 * dmax + 1)
    off = np.tile(np.arange(-dmax, dmax + 1, dtype=np.int64), n)
    j = i + off
    keep = (
        (j >= 0) & (j < n)
        & (rng.random(len(j)) < np.exp(-np.abs(off) / 3.0))
    )
    sig = rng.permutation(n).astype(np.int64)
    rows, cols = sig[i[keep]], sig[j[keep]]
    rbs = np.empty(n, np.int32)
    rbs[sig] = sizes  # sizes follow the hidden chain ordering
    blocks = [
        rng.standard_normal((rbs[r], rbs[c])).astype(np.float32)
        for r, c in zip(rows, cols)
    ]
    from dbcsr_tpu.block.bcsr import BCSRMatrix

    a = BCSRMatrix.from_blocks(rows, cols, blocks, rbs, rbs, name="A")

    perms = dt.locality_block_permutation(a.index)
    assert perms is not None
    pm, pk, pn = perms
    assert np.array_equal(pm, pk) and np.array_equal(pk, pn)
    ap = dt.permute_blocks(a, pm, pn)

    # dense equality under the row/col element permutation
    d = np.asarray(a.to_dense())
    dp = np.asarray(ap.to_dense())
    eoff = a.index.row_offsets
    noff = ap.index.row_offsets
    for old in range(n):
        new = int(pm[old])
        np.testing.assert_allclose(
            d[eoff[old]:eoff[old] + rbs[old]].sum(axis=1),
            dp[noff[new]:noff[new] + rbs[old]].sum(axis=1),
            rtol=1e-5, atol=1e-5,
        )

    # locality recovered: tile count shrinks substantially
    assert ap.layout.n_tiles < 0.5 * a.layout.n_tiles

    # round trip via inverse permutation restores the original matrix
    back = dt.permute_blocks(ap, np.argsort(pm), np.argsort(pn))
    np.testing.assert_allclose(
        np.asarray(back.to_dense()), d, rtol=0, atol=0
    )


def test_block_permutation_multiply_equivalence():
    """C(perm) == perm(C): multiplying permuted operands equals
    permuting the reference product."""
    import dbcsr_tpu as dt

    rng = np.random.default_rng(13)
    rbs = dt.random_block_sizes(300, [4, 7], rng)
    n = len(rbs)
    a = dt.random_matrix(rbs, rbs, 0.2, rng, dtype=np.float32, name="A")
    b = dt.random_matrix(rbs, rbs, 0.2, rng, dtype=np.float32, name="B")
    pm = np.random.default_rng(1).permutation(n).astype(np.int64)
    pk = np.random.default_rng(2).permutation(n).astype(np.int64)
    pn = np.random.default_rng(3).permutation(n).astype(np.int64)
    c_ref = dt.multiply("N", "N", 1.0, a, b)
    cp = dt.multiply(
        "N", "N", 1.0,
        dt.permute_blocks(a, pm, pk), dt.permute_blocks(b, pk, pn),
    )
    want = np.asarray(dt.permute_blocks(c_ref, pm, pn).to_dense())
    np.testing.assert_allclose(
        np.asarray(cp.to_dense()), want, atol=1e-4
    )


@pytest.mark.parametrize("sym", ["S", "A", "H"])
def test_block_permutation_symmetric_similarity(sym):
    """Similarity permutation (row_perm == col_perm) of a one-triangle
    matrix preserves the symmetry flag AND the dense expansion: stored
    blocks whose images cross the diagonal are re-stored as their
    (signed/conjugated) transpose. Regression: round-3 review found the
    moved blocks were previously dropped untransposed into the lower
    triangle (reading back as zeros)."""
    import dbcsr_tpu as dt

    rng = np.random.default_rng(5)
    rbs = dt.random_block_sizes(40, [3, 5, 8], rng)
    n = len(rbs)
    dtype = np.complex64 if sym == "H" else np.float32
    a = dt.random_matrix(rbs, rbs, 0.4, rng, dtype=dtype, sym=sym, name="A")
    p = np.random.default_rng(11).permutation(n).astype(np.int64)
    ap = dt.permute_blocks(a, p, p)
    assert ap.sym == sym

    dense = np.asarray(a.to_dense())
    eoff = np.concatenate(([0], np.cumsum(a.index.row_block_sizes)))
    new_eoff = np.concatenate(([0], np.cumsum(ap.index.row_block_sizes)))
    ne = dense.shape[0]
    eperm = np.empty(ne, dtype=np.int64)
    for i in range(n):
        eperm[new_eoff[p[i]]:new_eoff[p[i]] + (eoff[i + 1] - eoff[i])] = (
            np.arange(eoff[i], eoff[i + 1])
        )
    want = dense[np.ix_(eperm, eperm)]
    np.testing.assert_allclose(
        np.asarray(ap.to_dense()), want, atol=1e-5
    )


def test_block_permutation_symmetric_unequal_perms_desymmetrizes():
    """Different row/col permutations break symmetry: the result is the
    correctly-permuted FULL matrix with sym='N'."""
    import dbcsr_tpu as dt

    rng = np.random.default_rng(6)
    rbs = dt.random_block_sizes(30, [4, 6], rng)
    n = len(rbs)
    a = dt.random_matrix(rbs, rbs, 0.4, rng, dtype=np.float32, sym="S")
    pr = np.random.default_rng(21).permutation(n).astype(np.int64)
    pc = np.random.default_rng(22).permutation(n).astype(np.int64)
    ap = dt.permute_blocks(a, pr, pc)
    assert ap.sym == "N"

    dense = np.asarray(a.to_dense())
    roff = np.concatenate(([0], np.cumsum(a.index.row_block_sizes)))
    nr = np.concatenate(([0], np.cumsum(ap.index.row_block_sizes)))
    ncf = np.concatenate(([0], np.cumsum(ap.index.col_block_sizes)))
    ne = dense.shape[0]
    rp = np.empty(ne, dtype=np.int64)
    cp = np.empty(ne, dtype=np.int64)
    for i in range(n):
        w = roff[i + 1] - roff[i]
        rp[nr[pr[i]]:nr[pr[i]] + w] = np.arange(roff[i], roff[i + 1])
        cp[ncf[pc[i]]:ncf[pc[i]] + w] = np.arange(roff[i], roff[i + 1])
    want = dense[np.ix_(rp, cp)]
    np.testing.assert_allclose(
        np.asarray(ap.to_dense()), want, atol=1e-5
    )
