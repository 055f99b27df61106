"""The engine's one kernel decision (``mm.engine.select_route``) for each
platform, dtype and driver, and the executors built on it."""
import numpy as np
import pytest

import dbcsr_tpu as dt
from dbcsr_tpu.core.config import config_override, get_config
from dbcsr_tpu.core.errors import DbcsrError
from dbcsr_tpu.core.stats import get_stats
from dbcsr_tpu.mm.band import plan_band
from dbcsr_tpu.mm.engine import ROUTES, build_multiply_executor, select_route
from dbcsr_tpu.mm.tileplan import plan_tile_stacks_stores

TILE = 16


def _banded(rng, n=120, w=3, dtype=np.float32):
    from dbcsr_tpu.block.index import build_index

    rbs = dt.random_block_sizes(n, [3, 5], rng)
    nb = len(rbs)
    i = np.repeat(np.arange(nb, dtype=np.int64), 2 * w + 1)
    j = i + np.tile(np.arange(-w, w + 1, dtype=np.int64), nb)
    keep = (j >= 0) & (j < nb)
    idx, _ = build_index(i[keep], j[keep], rbs, rbs)
    return idx


def _route(driver, dtype, platform, idx):
    with config_override(tile_size=TILE):
        from dbcsr_tpu.block.store import store_layout

        lay = store_layout(idx, TILE)
        return select_route(
            get_config(), driver, dtype, TILE, lay.tile_coords,
            lay.tile_coords, (lay.ntr, lay.ntc, lay.ntc), idx, idx,
            platform=platform,
        ), lay


@pytest.mark.parametrize("driver", ["auto", "stack", "xla", "band", "dense"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_select_route(rng, platform, dtype, driver):
    import jax.numpy as jnp

    dt_ = jnp.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    idx = _banded(rng)
    route, lay = _route(driver, dt_, platform, idx)
    kernel = platform == "gpu" and dtype != "float64"
    stack_kind = "crun" if kernel else "xla"
    if driver == "dense":
        assert route.kind == "dense" and route.tplan is None
        return
    assert route.tplan is not None
    if driver == "xla":
        assert route.kind == "xla"
    elif driver == "stack":
        assert route.kind == stack_kind
    elif driver == "band":
        assert route.kind == "band" and route.bplan is not None
    else:  # auto: band when the heuristic admits it, else a stack product
        tp = plan_tile_stacks_stores(
            lay.tile_coords, (lay.ntr, lay.ntc), lay.tile_coords,
            (lay.ntr, lay.ntc),
        )
        cfg = get_config()
        admitted = plan_band(
            lay.tile_coords, (lay.ntr, lay.ntc), lay.tile_coords,
            (lay.ntr, lay.ntc), tp.c_tile_keys, tile=TILE,
            n_stack=len(tp.stack), max_products=cfg.band_max_products,
            flop_factor=cfg.band_flop_factor * 0.125,
        ) is not None
        if len(tp.stack) / max(lay.ntr ** 3, 1) >= cfg.dense_threshold:
            assert route.kind == "dense"
        else:
            assert route.kind == ("band" if admitted else stack_kind)
    assert route.kind in ROUTES


def test_select_route_ozaki_and_errors(rng):
    idx = _banded(rng)
    with config_override(f64_method="ozaki"):
        assert _route("stack", np.float64, "gpu", idx)[0].kind == "ozaki"
        assert _route("stack", np.float32, "gpu", idx)[0].kind == "crun"
    with config_override(matmul_precision="high"):
        assert _route("stack", np.float32, "gpu", idx)[0].kind == "xla"
    with config_override(matmul_precision="default"):
        assert _route("stack", np.float32, "gpu", idx)[0].kind == "crun"
    with pytest.raises(DbcsrError):
        _route("panel", np.float32, "gpu", idx)
    # a uniform-random pattern is not band-suitable
    a = dt.random_matrix(*(dt.random_block_sizes(200, [5], rng),) * 2, 0.3,
                         rng, dtype=np.float32)
    with config_override(tile_size=TILE, band_max_products=4):
        lay = a.layout
        with pytest.raises(DbcsrError):
            select_route(
                get_config(), "band", np.float32, TILE, lay.tile_coords,
                lay.tile_coords, (lay.ntr, lay.ntc, lay.ntc), a.index,
                a.index, platform="gpu",
            )


def test_crun_needs_a_supported_tile(rng):
    """Tiles the Triton dot cannot take stay on XLA even on the GPU."""
    idx = _banded(rng)
    from dbcsr_tpu.block.store import store_layout

    lay = store_layout(idx, 8)
    r = select_route(
        get_config(), "stack", np.float32, 8, lay.tile_coords,
        lay.tile_coords, (lay.ntr, lay.ntc, lay.ntc), idx, idx,
        platform="gpu",
    )
    assert r.kind == "xla"


@pytest.mark.parametrize("driver", ["auto", "stack", "xla", "band", "dense"])
def test_executor_routes_agree(rng, driver):
    """Every route of the plan-once executor gives the same product, and
    the choice lands in the statistics."""
    from dbcsr_tpu.block.bcsr import BCSRMatrix

    idx = _banded(rng, n=90)
    with config_override(tile_size=TILE):
        from dbcsr_tpu.block.store import store_layout
        from dbcsr_tpu.block.tileops import valid_mask
        import jax

        lay = store_layout(idx, TILE)
        data = jax.random.normal(
            jax.random.PRNGKey(1), (lay.n_tiles, TILE, TILE)
        ) * valid_mask(idx, TILE)
        a = BCSRMatrix(name="A", index=idx, data=data)
        before = dict(get_stats().routes)
        fn, c_index, _ = build_multiply_executor(
            "N", "N", a, a, driver=driver
        )
        changed = {k for k, v in get_stats().routes.items()
                   if v != before.get(k, 0)}
        assert len(changed) == 1 and changed <= set(ROUTES)
        c = BCSRMatrix(name="C", index=c_index, data=fn(a.data, a.data))
        ref = np.asarray(a.to_dense()) @ np.asarray(a.to_dense())
        np.testing.assert_allclose(
            np.asarray(c.to_dense()), ref, atol=1e-10
        )
    assert "product routes" in dt.print_statistics()
