"""ozaki f64 path (ops/f64_emu.py): exact bf16 slice products.

Accuracy model under test: every intermediate (power-of-two scaling,
8-bit slicing, bf16 matrix products, 128-term f32 accumulation) is exact;
the only roundings are the final f64 combine and the dropped slice
pairs with i + j >= S. At S = 7 the result must be f64-grade — far
beyond anything a single f32 pass can deliver.

Reference analog: fp64 is the reference GPU backend's primary type
(/root/reference/src/acc/libsmm_acc/libsmm_acc.cpp:92-150).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import dbcsr_tpu as dt
from dbcsr_tpu.ops.f64_emu import (
    ozaki_matmul,
    ozaki_slices,
    tile_stack_matmul_ozaki,
)


def _rel_err(got, ref):
    return np.max(np.abs(np.asarray(got) - ref)) / max(np.max(np.abs(ref)),
                                                       1e-300)


def test_slices_reconstruct_exactly():
    """S slices reconstruct the top 8S bits of the scaled mantissa."""
    rng = np.random.default_rng(0)
    y = jnp.asarray(rng.uniform(-1.0, 1.0, 512), jnp.float64)
    sl = ozaki_slices(y, 7)
    back = sum(s.astype(jnp.float64) for s in sl)
    assert float(jnp.max(jnp.abs(back - y))) < 2.0 ** -55


def test_dense_matches_numpy_f64():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((93, 257))
    b = rng.standard_normal((257, 71))
    ref = a @ b
    got = ozaki_matmul(jnp.asarray(a), jnp.asarray(b))
    assert _rel_err(got, ref) < 1e-13


def test_batched_matches_numpy_f64():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((4, 40, 128))
    b = rng.standard_normal((4, 128, 36))
    ref = a @ b
    got = ozaki_matmul(jnp.asarray(a), jnp.asarray(b))
    assert _rel_err(got, ref) < 1e-13


def test_beats_f32_by_orders():
    """The case a plain f32 (or bf16x6) pass cannot represent: values
    1 + eps with eps ~ 1e-10; the products' low bits carry the signal."""
    rng = np.random.default_rng(3)
    eps = rng.standard_normal((64, 128)) * 1e-10
    a = 1.0 + eps
    b = np.ones((128, 64)) + rng.standard_normal((128, 64)) * 1e-10
    ref = a @ b
    got = ozaki_matmul(jnp.asarray(a), jnp.asarray(b))
    f32 = np.asarray(
        jnp.matmul(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))
    ).astype(np.float64)
    # the interesting signal is O(1e-8) on top of 128.0; a single f32
    # pass loses it to input quantization (how much varies by backend —
    # assert the ratio, not a platform-specific floor)
    oz_err = np.max(np.abs(np.asarray(got) - ref))
    f32_err = np.max(np.abs(f32 - ref))
    assert oz_err < 1e-11
    assert oz_err < f32_err / 100.0


def test_wild_exponent_rows():
    """Per-row/column power-of-two scaling: rows spanning 2^-30..2^30."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((32, 256)) * np.exp2(
        rng.integers(-30, 30, (32, 1)).astype(np.float64)
    )
    b = rng.standard_normal((256, 48)) * np.exp2(
        rng.integers(-30, 30, (1, 48)).astype(np.float64)
    )
    ref = a @ b
    got = ozaki_matmul(jnp.asarray(a), jnp.asarray(b))
    # error is relative to sum|a||b| per element (condition caveat)
    bound = np.abs(a) @ np.abs(b)
    err = np.abs(np.asarray(got) - ref)
    assert np.max(err / bound) < 1e-13


def test_k_padding_and_slices_knob():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((17, 130))
    b = rng.standard_normal((130, 19))
    ref = a @ b
    got7 = ozaki_matmul(jnp.asarray(a), jnp.asarray(b), n_slices=7)
    got4 = ozaki_matmul(jnp.asarray(a), jnp.asarray(b), n_slices=4)
    assert _rel_err(got7, ref) < 1e-13
    e4 = _rel_err(got4, ref)
    assert 1e-13 < e4 < 1e-7  # 4 slices ~ 32 bits: between f32 and f64


def test_tile_stack_ozaki_vs_oracle():
    rng = np.random.default_rng(6)
    t = 32
    na, nb, nc = 6, 5, 4
    a_tiles = rng.standard_normal((na, t, t))
    b_tiles = rng.standard_normal((nb, t, t))
    stack = np.array(
        [[0, 0, 0], [0, 1, 1], [1, 2, 2], [2, 3, 3], [2, 4, 4], [2, 5, 0]],
        dtype=np.int32,
    )
    ref = np.zeros((nc, t, t))
    for c, ia, ib in stack:
        ref[c] += a_tiles[ia] @ b_tiles[ib]
    got = tile_stack_matmul_ozaki(
        jnp.asarray(a_tiles), jnp.asarray(b_tiles), jnp.asarray(stack),
        n_c_tiles=nc,
    )
    assert _rel_err(got, ref) < 1e-13


@pytest.mark.parametrize("method", ["ozaki", "native"])
def test_engine_multiply_f64(method):
    """Engine-level f64 multiply routes by f64_method and matches the
    dense f64 oracle at f64-grade accuracy either way."""
    rng = np.random.default_rng(7)
    rbs = dt.random_block_sizes(30, [5, 13, 23], rng)
    a = dt.random_matrix(rbs, rbs, 0.3, rng, dtype=np.float64)
    b = dt.random_matrix(rbs, rbs, 0.3, rng, dtype=np.float64)
    ref = np.asarray(a.to_dense()) @ np.asarray(b.to_dense())
    with dt.config_override(f64_method=method):
        c = dt.multiply("N", "N", 1.0, a, b, 0.0)
    got = np.asarray(c.to_dense())
    scale = max(np.max(np.abs(ref)), 1.0)
    assert np.max(np.abs(got - ref)) / scale < 1e-12


def test_engine_dense_f64_ozaki():
    """Tile-complete f64 operands exercise the dense ozaki route."""
    rng = np.random.default_rng(8)
    rbs = np.full(4, 32, dtype=np.int32)
    a = dt.random_matrix(rbs, rbs, 1.0, rng, dtype=np.float64)
    b = dt.random_matrix(rbs, rbs, 1.0, rng, dtype=np.float64)
    ref = np.asarray(a.to_dense()) @ np.asarray(b.to_dense())
    with dt.config_override(f64_method="ozaki"):
        c = dt.multiply("N", "N", 1.0, a, b, 0.0)
    got = np.asarray(c.to_dense())
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-12


def test_auto_routes_per_class():
    """The default ``f64_method="auto"`` means the native f64 dot for every
    workload class (dense and stack); only an explicit "ozaki" takes the
    slice schemes, and f32 never does."""
    import jax.numpy as jnp

    from dbcsr_tpu.core.config import get_config
    from dbcsr_tpu.mm.engine import _use_ozaki, select_route

    cfg = get_config()
    assert cfg.f64_method == "auto"  # the shipped default
    assert _use_ozaki(jnp.float64, cfg) is False
    assert _use_ozaki(jnp.float32, cfg) is False
    with dt.config_override(f64_method="native"):
        assert not _use_ozaki(jnp.float64, get_config())
    with dt.config_override(f64_method="ozaki"):
        c = get_config()
        assert _use_ozaki(jnp.float64, c)
        assert not _use_ozaki(jnp.float32, c)
    # the engine's route for a sparse f64 stack: native XLA unless asked
    rng = np.random.default_rng(4)
    rbs = dt.random_block_sizes(40, [5, 13], rng)
    a = dt.random_matrix(rbs, rbs, 0.05, rng, dtype=np.float64)
    lay = a.layout
    args = (
        "stack", np.float64, a.tile, lay.tile_coords, lay.tile_coords,
        (lay.ntr, lay.ntc, lay.ntc), a.index, a.index,
    )
    for platform in ("cpu", "gpu"):
        assert select_route(cfg, *args, platform=platform).kind == "xla"
        with dt.config_override(f64_method="ozaki"):
            r = select_route(get_config(), *args, platform=platform)
            assert r.kind == "ozaki"


def test_auto_dense_f64_never_calls_ozaki(monkeypatch):
    """A DENSE-TILE f64 multiply under the default config must take XLA's
    native f64 dot — sabotage the ozaki entry points and require the
    multiply to still succeed."""
    import dbcsr_tpu.ops.f64_emu as emu

    def boom(*a, **k):
        raise AssertionError("ozaki path taken for a dense f64 product")

    monkeypatch.setattr(emu, "ozaki_matmul", boom)
    monkeypatch.setattr(emu, "tile_stack_matmul_ozaki", boom)
    rng = np.random.default_rng(9)
    rbs = np.full(4, 32, dtype=np.int32)
    a = dt.random_matrix(rbs, rbs, 1.0, rng, dtype=np.float64)
    b = dt.random_matrix(rbs, rbs, 1.0, rng, dtype=np.float64)
    ref = np.asarray(a.to_dense()) @ np.asarray(b.to_dense())
    c = dt.multiply("N", "N", 1.0, a, b, 0.0)
    got = np.asarray(c.to_dense())
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-12


def test_stack_ozaki_wide_dynamic_range():
    """Per-tile-row scaling must keep accuracy when magnitudes vary by
    many orders across rows AND tiles (the store-level slicing of round 5
    scales per (tile, row) exactly like the per-chunk scheme did)."""
    import jax.numpy as jnp

    from dbcsr_tpu.ops.f64_emu import tile_stack_matmul_ozaki

    rng = np.random.default_rng(3)
    t = 128
    a_tiles = rng.standard_normal((3, t, t)) * np.exp2(
        rng.integers(-30, 30, (3, t, 1)).astype(np.float64)
    )
    b_tiles = rng.standard_normal((3, t, t)) * np.exp2(
        rng.integers(-30, 30, (3, 1, t)).astype(np.float64)
    )
    stack = np.array([[0, 0, 0], [0, 1, 1], [1, 2, 2]], dtype=np.int32)
    ref = np.zeros((2, t, t))
    for c, ia, ib in stack:
        ref[c] += a_tiles[ia] @ b_tiles[ib]
    got = np.asarray(tile_stack_matmul_ozaki(
        jnp.asarray(a_tiles), jnp.asarray(b_tiles), jnp.asarray(stack),
        n_c_tiles=2,
    ))
    bound = np.zeros((2, t, t))
    for c, ia, ib in stack:
        bound[c] += np.abs(a_tiles[ia]) @ np.abs(b_tiles[ib])
    assert np.max(np.abs(got - ref) / np.maximum(bound, 1e-300)) < 1e-13


def test_stack_ozaki_empty_and_zero_tiles():
    import jax.numpy as jnp

    from dbcsr_tpu.ops.f64_emu import tile_stack_matmul_ozaki

    t = 16
    a = jnp.zeros((2, t, t), jnp.float64)
    b = jnp.zeros((2, t, t), jnp.float64)
    stack = jnp.asarray(np.array([[0, 0, 0]], dtype=np.int32))
    out = np.asarray(
        tile_stack_matmul_ozaki(a, b, stack, n_c_tiles=1)
    )
    assert out.shape == (1, t, t) and not out.any()
