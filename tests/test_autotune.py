"""Autotune subsystem tests (small grids/workloads for CI speed)."""
import json
import os

import numpy as np
import pytest

import dbcsr_tpu as dt
from dbcsr_tpu import autotune
from dbcsr_tpu.core.config import get_config, reset_config


@pytest.fixture(autouse=True)
def _fresh_config():
    yield
    reset_config()


def _tiny_workload(rng):
    rbs = dt.random_block_sizes(80, [5, 13], rng)
    a = dt.random_matrix(rbs, rbs, 0.3, rng, dtype=np.float32, name="A")
    b = dt.random_matrix(rbs, rbs, 0.3, rng, dtype=np.float32, name="B")
    return a, b


def test_sweep_and_apply(tmp_path, monkeypatch):
    monkeypatch.setitem(autotune.WORKLOADS, "tiny", _tiny_workload)
    table = autotune.sweep(
        grid={"mm_driver": ["dense", "xla"], "tile_size": [64]},
        workloads=["tiny"],
        verbose=False,
    )
    best = table["results"]["tiny"]["best"]
    assert best is not None and best["gflops"] > 0
    assert len(table["results"]["tiny"]["all"]) == 2

    path = autotune.save_params(table, str(tmp_path / "params.json"))
    with open(path) as f:
        loaded = json.load(f)
    assert loaded["device_kind"] == table["device_kind"]

    assert autotune.apply_tuned("tiny", table=loaded)
    cfg = get_config()
    assert cfg.mm_driver == best["mm_driver"]
    assert cfg.tile_size == best["tile_size"]


def test_merge_keeps_measured_entry_over_empty_sweep(tmp_path, monkeypatch):
    """--merge must not clobber a previously MEASURED class entry with a
    best=None result from a sweep where every combo failed: stale-but-real beats fresh-but-empty."""
    good = {"best": {"mm_driver": "stack", "gflops": 962.0}, "all": []}
    fresh = {"best": {"mm_driver": "band", "gflops": 1500.0}, "all": []}
    monkeypatch.setattr(
        autotune, "sweep",
        lambda **kw: {"device_kind": "k", "results": {
            "banded_fine_large": {"best": None, "all": []},
            "banded_fine": fresh,
        }},
    )
    monkeypatch.setattr(
        autotune, "load_params",
        lambda kind=None: {"device_kind": "k", "results": {
            "banded_fine_large": good,
        }},
    )
    out = str(tmp_path / "t.json")
    autotune.main(["--merge", "--out", out])
    with open(out) as f:
        merged = json.load(f)["results"]
    assert merged["banded_fine_large"] == good      # kept, not clobbered
    assert merged["banded_fine"] == fresh            # real result merged


def test_workload_class_buckets():
    assert autotune.workload_class([23], 1.0) == "block23_dense"
    assert autotune.workload_class([5], 0.1) == "block5_sparse10"
    assert autotune.workload_class([5, 13, 23], 0.2) == "mixed_5_13_23_sparse20"
    assert autotune.workload_class([5, 13, 23], 0.001) == "banded_fine"


def test_tuned_stack_params_lookup(rng, monkeypatch):
    """The engine's per-class runtime lookup: a tuned driver is adopted
    while mm_driver keeps its default provenance; a user-set driver wins."""
    from dbcsr_tpu.core.config import config_override
    from dbcsr_tpu.mm.engine import _tuned_driver

    rbs = dt.random_block_sizes(300, [5, 13], rng)
    a = dt.random_matrix(rbs, rbs, 0.005, rng, dtype=np.float32)
    b = dt.random_matrix(rbs, rbs, 0.005, rng, dtype=np.float32)
    fake = {"results": {"banded_fine": {"best": {"mm_driver": "band"}}}}
    monkeypatch.setitem(autotune._TABLE_CACHE, "kind", None)
    monkeypatch.setattr(autotune, "load_params", lambda kind=None: fake)
    cfg = get_config()
    assert autotune.tuned_stack_params(a.index, b.index) == {
        "mm_driver": "band"
    }
    assert _tuned_driver(cfg, a.index, b.index) == "band"
    with config_override(mm_driver="auto") as cfg2:
        assert _tuned_driver(cfg2, a.index, b.index) is None  # user wins
    # engine path end-to-end with the tuned driver in play
    c = dt.multiply("N", "N", 1.0, a, b)
    ref = np.asarray(a.to_dense()) @ np.asarray(b.to_dense())
    np.testing.assert_allclose(np.asarray(c.to_dense()), ref, atol=1e-5)


def test_steady_state_time_positive():
    import jax.numpy as jnp

    def fn(x):
        return (x * 2.0).sum(keepdims=True)

    t = autotune.steady_state_time(
        fn, (jnp.ones(1024, dtype=jnp.float32),), n_lo=1, n_hi=4, reps=2
    )
    assert t > 0


def test_apply_tuned_missing_table_returns_false():
    assert not autotune.apply_tuned("nope", table={"results": {}})


def test_feature_nearest_class_holdout(rng):
    """UNSEEN workload shapes map to the tuned class whose swept shape
    they share structure with (the smm_acc_predict analog). The table is
    built here from the feature vectors of small stand-ins of the swept
    classes; holdout shapes differ in scale, occupancy and bandwidth."""
    import dbcsr_tpu as dt
    from dbcsr_tpu.autotune import nearest_class, workload_features
    from dbcsr_tpu.block.index import build_index

    def banded(nrows, w, fill):
        rbs = dt.random_block_sizes(nrows, [5, 13, 23], rng)
        n = len(rbs)
        i = np.repeat(np.arange(n, dtype=np.int64), 2 * w + 1)
        j = i + np.tile(np.arange(-w, w + 1, dtype=np.int64), n)
        keep = (j >= 0) & (j < n) & (rng.random(len(j)) < fill)
        idx, _ = build_index(i[keep], j[keep], rbs, rbs)
        return idx

    def uniform(nrows, sizes, occ):
        rbs = dt.random_block_sizes(nrows, sizes, rng)
        return dt.random_matrix(rbs, rbs, occ, rng, dtype=np.float32).index

    swept = {
        "block23_dense": uniform(1500, [23], 1.0),
        "block5_sparse10": uniform(1500, [5], 0.10),
        "mixed_5_13_23_sparse20": uniform(1500, [5, 13, 23], 0.20),
        "banded_fine": banded(12000, 12, 0.5),
    }
    table = {"results": {
        cls: {"features": list(workload_features(ix, ix)),
              "best": {"mm_driver": "stack"}}
        for cls, ix in swept.items()
    }}

    # holdout 1: banded, different scale (30k rows) and bandwidth (8)
    idx = banded(30000, 8, 0.6)
    cls, d = nearest_class(workload_features(idx, idx), table)
    assert cls == "banded_fine", (cls, d)
    # holdout 2: dense-blocked, larger blocks (27) at full occupancy
    ix2 = uniform(1000, [27], 1.0)
    assert nearest_class(workload_features(ix2, ix2), table)[0] == (
        "block23_dense"
    )
    # holdout 3: fine uniform blocks, 5% occupancy
    ix3 = uniform(2500, [4], 0.05)
    assert nearest_class(workload_features(ix3, ix3), table)[0] == (
        "block5_sparse10"
    )
    # holdout 4: mixed sizes at 30% occupancy
    ix4 = uniform(2000, [5, 13, 23], 0.30)
    assert nearest_class(workload_features(ix4, ix4), table)[0] == (
        "mixed_5_13_23_sparse20"
    )
    # no table for this device: the lookup returns nothing
    assert nearest_class(workload_features(ix4, ix4), {"results": {}}) is None
