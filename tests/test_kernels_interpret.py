"""The C-run stack kernel (Pallas through Triton) in interpret mode on the
CPU: run accumulation, empty C slots, long runs, dtypes, precisions and
tile edges against the XLA reference ``tile_stack_matmul_xla``."""
import numpy as np
import pytest

import jax.numpy as jnp

from dbcsr_tpu.mm.kernels import (
    CRUN_LAUNCH,
    _crun_launch,
    crun_supported,
    run_pointers,
    tile_stack_matmul_crun,
    tile_stack_matmul_xla,
)


def _stack(rng, shape, n_tiles):
    """(stack [S,3] sorted by c, n_c) for one run-shape family."""
    if shape == "empty_slots":  # C slots 1 and 3 have no entries
        c_col = np.array([0, 0, 2, 2, 2, 4])
        n_c = 5
    elif shape == "single_entry":  # every run has exactly one entry
        c_col = np.arange(6)
        n_c = 6
    elif shape == "long_runs":
        c_col = np.repeat(np.arange(3), 9)
        n_c = 3
    else:  # one_very_long: one run of 40 among short ones
        c_col = np.concatenate([[0], np.full(40, 1), [2, 2]])
        n_c = 3
    s = len(c_col)
    stack = np.stack(
        [c_col, rng.integers(0, n_tiles, s), rng.integers(0, n_tiles, s)],
        axis=1,
    ).astype(np.int32)
    return stack, n_c


@pytest.mark.parametrize(
    "shape", ["empty_slots", "single_entry", "long_runs", "one_very_long"]
)
@pytest.mark.parametrize("tile", [16, 32, 128])
@pytest.mark.parametrize("prec", ["highest", "default"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_crun_matches_xla(rng, dtype, prec, tile, shape):
    n_tiles = 5
    a = jnp.asarray(rng.standard_normal((n_tiles, tile, tile)), dtype)
    b = jnp.asarray(rng.standard_normal((n_tiles, tile, tile)), dtype)
    stack, n_c = _stack(rng, shape, n_tiles)
    ref = tile_stack_matmul_xla(
        a.astype(jnp.float32), b.astype(jnp.float32), jnp.asarray(stack),
        n_c_tiles=n_c, precision="highest",
    )
    got = tile_stack_matmul_crun(
        a, b, stack, n_c_tiles=n_c, precision=prec, out_dtype=jnp.float32,
        interpret=True,
    )
    assert got.shape == (n_c, tile, tile) and got.dtype == jnp.float32
    # f32 accumulation of exactly-representable inputs: both sides agree
    # to f32 rounding whatever the precision asks of a GPU
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(ref), rtol=1e-5, atol=1e-4 * tile
    )
    empty = np.setdiff1d(np.arange(n_c), stack[:, 0])
    assert not np.asarray(got)[empty].any()


def test_crun_bitwise_deterministic(rng):
    """One owner per C sub-block, no atomics: repeated runs are bitwise
    identical."""
    a = jnp.asarray(rng.standard_normal((6, 32, 32)), jnp.float32)
    b = jnp.asarray(rng.standard_normal((6, 32, 32)), jnp.float32)
    stack, n_c = _stack(rng, "one_very_long", 6)
    runs = [
        np.asarray(tile_stack_matmul_crun(
            a, b, stack, n_c_tiles=n_c, interpret=True
        ))
        for _ in range(3)
    ]
    assert all(np.array_equal(runs[0], r) for r in runs[1:])


def test_crun_empty_stack_and_out_dtype(rng):
    a = jnp.zeros((2, 16, 16), jnp.bfloat16)
    out = tile_stack_matmul_crun(
        a, a, np.zeros((0, 3), np.int32), n_c_tiles=3,
        out_dtype=jnp.float32, interpret=True,
    )
    assert out.shape == (3, 16, 16) and out.dtype == jnp.float32
    assert not np.asarray(out).any()


@pytest.mark.parametrize("prec", sorted(CRUN_LAUNCH))
def test_crun_launch_shapes(rng, prec):
    """Every launch shape of the table, and a smaller sub-block than the
    table's, give the same product (another K step sums in another order:
    they agree to f32 rounding)."""
    a = jnp.asarray(rng.standard_normal((4, 128, 128)), jnp.float32)
    b = jnp.asarray(rng.standard_normal((4, 128, 128)), jnp.float32)
    stack, n_c = _stack(rng, "long_runs", 4)
    args = (a, b, jnp.asarray(run_pointers(stack[:, 0], n_c)),
            jnp.asarray(stack[:, 1]), jnp.asarray(stack[:, 2]))
    common = dict(n_c_tiles=n_c, precision="highest",
                  out_dtype=jnp.dtype(jnp.float32), interpret=True)
    base = _crun_launch(*args, **common, **CRUN_LAUNCH[prec])
    alt = _crun_launch(*args, **common, bm=32, bn=64, bk=16, num_warps=4,
                       num_stages=2)
    np.testing.assert_allclose(
        np.asarray(alt), np.asarray(base), rtol=1e-5, atol=1e-3
    )


def test_run_pointers():
    ptr = run_pointers(np.array([0, 0, 2, 2, 2, 4]), 6)
    assert ptr.tolist() == [0, 2, 2, 5, 5, 6, 6]
    assert run_pointers(np.zeros(0, np.int32), 2).tolist() == [0, 0, 0]


@pytest.mark.parametrize(
    "dtype,tile,ok",
    [
        ("float32", 128, True), ("bfloat16", 64, True), ("float32", 16, True),
        ("float32", 8, False), ("float32", 96, False),
        ("float64", 128, False), ("complex64", 128, False),
    ],
)
def test_crun_supported(dtype, tile, ok):
    dt_ = np.dtype(dtype) if dtype != "bfloat16" else jnp.bfloat16
    assert crun_supported(dt_, tile, "highest") is ok
    assert crun_supported(dt_, tile, "default") is ok
    assert crun_supported(dt_, tile, "high") is False
