"""Autotuning: sweep engine/kernel configs per workload class, store the
winners in a JSON parameter table keyed by device kind.

Analog of the reference's autotuning pipeline
(``src/acc/libsmm_acc/tune/tune_setup.py`` + per-GPU
``parameters/parameters_*.json``, selection logic
``kernels/smm_acc_predict.py``): the reference sweeps CUDA launch
parameters per (m,n,k) triplet and records GFLOP/s; here the sweep covers
the engine's knobs — hardware tile size, driver choice, matmul precision —
per *workload class* (block-size profile × occupancy bucket), because the
two-level design makes per-triplet kernels unnecessary (every stack entry
is a T×T×T tile product regardless of user block sizes). No table ships:
the engine runs untuned until a sweep on the device writes one.

Usage:
  python -m dbcsr_tpu.autotune --out dbcsr_tpu/params/<device>.json
  dbcsr_tpu.autotune.apply_tuned()   # adopt stored winners at runtime
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import time
from functools import partial
from typing import Callable, Dict, List, Optional

import numpy as np

__all__ = [
    "WORKLOADS",
    "steady_state_time",
    "sweep",
    "save_params",
    "load_params",
    "apply_tuned",
    "workload_class",
]

PARAMS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "params")

# knobs swept per workload class (the analog of the reference's
# threads/grouping/minblocks/tile_m/tile_n/w/v template space)
DEFAULT_GRID = {
    "tile_size": [64, 128],
    "mm_driver": ["dense", "stack"],
    "matmul_precision": ["default", "highest"],
}

#: default sweep: per-driver sub-grids (a flat cartesian product would
#: waste most of its combos on knobs the driver ignores). Keys mirror the
#: config parameters; every row records its ``mm_driver``.
DRIVER_GRIDS = {
    "dense": {
        "tile_size": [64, 128],
        "matmul_precision": ["default", "highest"],
    },
    "stack": {
        "tile_size": [64, 128],
        "matmul_precision": ["default", "highest"],
    },
    "band": {
        "matmul_precision": ["default", "highest"],
    },
}


def _mk_workload(block_sizes, occupancy):
    def build(rng):
        import dbcsr_tpu as dt

        rbs = dt.random_block_sizes(1500, block_sizes, rng)
        a = dt.random_matrix(rbs, rbs, occupancy, rng, dtype=np.float32, name="A")
        b = dt.random_matrix(rbs, rbs, occupancy, rng, dtype=np.float32, name="B")
        return a, b

    return build


def _mk_banded(nrows: int = 12000, bandwidth: int = 12):
    """Banded fine-blocked pattern (the linear-scaling SCF shape; too many
    block rows for the dense driver — exercises the stack path). Data is
    built directly in store form for construction speed."""

    def build(rng):
        import jax
        import jax.numpy as jnp

        import dbcsr_tpu as dt
        from dbcsr_tpu.block.bcsr import BCSRMatrix
        from dbcsr_tpu.block.index import build_index
        from dbcsr_tpu.block.store import store_layout
        from dbcsr_tpu.block.tileops import valid_mask
        from dbcsr_tpu.core.config import get_config

        rbs = dt.random_block_sizes(nrows, [5, 13, 23], rng)
        n = len(rbs)
        w = 2 * bandwidth + 1
        i = np.repeat(np.arange(n, dtype=np.int64), w)
        j = i + np.tile(np.arange(-bandwidth, bandwidth + 1, dtype=np.int64), n)
        keep = (j >= 0) & (j < n) & (rng.random(len(j)) < 0.5)
        idx, _ = build_index(i[keep], j[keep], rbs, rbs)
        t = get_config().tile_size
        lay = store_layout(idx, t)
        data = jax.random.normal(
            jax.random.PRNGKey(0), (lay.n_tiles, t, t), jnp.float32
        ) * valid_mask(idx, t)
        a = BCSRMatrix(name="A", index=idx, data=data)
        b = BCSRMatrix(name="B", index=idx, data=data * 0.5)
        return a, b

    return build


#: workload classes mirroring BASELINE.md configs: uniform 23³ dense-blocked,
#: uniform 5×5 sparse (dbcsr_example_3), mixed 5/13/23 (perf-driver recipe),
#: banded fine-blocked at scale (stack path)
WORKLOADS: Dict[str, Callable] = {
    "block23_dense": _mk_workload([23], 1.0),
    "block5_sparse10": _mk_workload([5], 0.10),
    "mixed_5_13_23_sparse20": _mk_workload([5, 13, 23], 0.20),
    "banded_fine": _mk_banded(),
    # same shape at ~3.3x the scale (the log_nblkrows feature separates
    # the two classes at lookup time)
    "banded_fine_large": _mk_banded(40000),
}


def workload_class(block_sizes, occupancy: float) -> str:
    """Coarse rule-based classification (fallback when the parameter table
    carries no feature vectors — pre-round-2 tables)."""
    mean_bs = float(np.mean(block_sizes))
    if occupancy > 0.6:
        return "block23_dense"
    if occupancy < 0.02:
        return "banded_fine"
    if mean_bs <= 8:
        return "block5_sparse10"
    return "mixed_5_13_23_sparse20"


# --- feature-based classification (smm_acc_predict analog) -----------------
#
# The reference trains a decision tree over derived kernel features to pick
# launch parameters for UNTUNED (m,n,k) triplets
# (``src/acc/libsmm_acc/kernels/smm_acc_predict.py:23-60``). Here every
# tuned workload class stores a FEATURE VECTOR of the swept workload;
# untuned shapes look up the nearest class in normalized feature space.

#: feature names, scales chosen so one unit ~ one "meaningful" step
_FEATURES = (
    "log_mean_bs",      # log2 mean block edge
    "bs_cv",            # block-size coefficient of variation
    "log_occupancy",    # log10 block-level occupancy
    "bandedness",       # 1 - normalized mean |i - j| spread of blocks
    "log_nblkrows",     # log10 problem scale
)


def coords_bandedness(rows, cols, n: int) -> float:
    """``1 - 3 * normalized mean |i - j|`` of a coordinate pattern:
    ~1 for banded/clustered, ~0 for uniform-random (whose spread is
    ~n/3). The single definition behind the ``bandedness`` feature.
    Empty patterns score 1.0
    (spread 0) — the value index_features always produced, kept so
    nearest-class lookups for degenerate operands are unchanged."""
    if len(rows) == 0:
        return 1.0
    spread = float(
        np.abs(
            np.asarray(rows, dtype=np.float64)
            - np.asarray(cols, dtype=np.float64)
        ).mean()
    ) / max(n, 1)
    return max(0.0, 1.0 - 3.0 * spread)


def index_features(index) -> np.ndarray:
    """Feature vector of one matrix index (pure metadata, O(nblks))."""
    sizes = np.concatenate(
        [index.row_block_sizes, index.col_block_sizes]
    ).astype(np.float64)
    mean_bs = max(float(sizes.mean()), 1.0)
    cv = float(sizes.std() / mean_bs)
    occ = index.nblks / max(index.nblkrows * index.nblkcols, 1)
    bandedness = coords_bandedness(
        index.blk_rows, index.col_idx,
        max(index.nblkrows, index.nblkcols, 1),
    )
    return np.array(
        [
            np.log2(mean_bs),
            cv,
            np.log10(max(occ, 1e-6)),
            bandedness,
            np.log10(max(index.nblkrows, 1)),
        ]
    )


def workload_features(a_index, b_index) -> np.ndarray:
    return 0.5 * (index_features(a_index) + index_features(b_index))


#: per-feature normalization: one unit of distance per entry
_FEATURE_SCALE = np.array([1.0, 0.3, 0.7, 0.35, 0.8])


def nearest_class(features: np.ndarray, table: dict):
    """(class name, distance) of the nearest tuned class by normalized
    feature distance; None if the table has no feature vectors."""
    best = None
    best_d = np.inf
    for cls, res in table.get("results", {}).items():
        fv = res.get("features")
        if fv is None:
            continue
        d = float(
            np.linalg.norm((np.asarray(fv) - features) / _FEATURE_SCALE)
        )
        if d < best_d:
            best, best_d = cls, d
    if best is None:
        return None
    return best, best_d


_TABLE_CACHE: dict = {}


def _cached_table() -> Optional[dict]:
    import jax

    kind = jax.devices()[0].device_kind
    if _TABLE_CACHE.get("kind") != kind:
        _TABLE_CACHE["kind"] = kind
        _TABLE_CACHE["table"] = load_params(kind)
    return _TABLE_CACHE["table"]


def tuned_stack_params(a_index, b_index) -> Optional[dict]:
    """Per-workload-class tuned config for the current device — the runtime
    analog of the reference's per-(m,n,k) parameter lookup at kernel launch
    (``libsmm_acc.cpp`` parameter hash table). The engine consults this for
    the driver choice when the user left ``mm_driver`` at its default;
    accuracy-affecting knobs (precision) are never auto-applied."""
    table = _cached_table()
    if table is None:
        return None
    hit = nearest_class(workload_features(a_index, b_index), table)
    if hit is not None:
        cls, _ = hit
    else:  # legacy table without feature vectors
        occ_a = a_index.nblks / max(a_index.nblkrows * a_index.nblkcols, 1)
        occ_b = b_index.nblks / max(b_index.nblkrows * b_index.nblkcols, 1)
        sizes = np.concatenate(
            [a_index.row_block_sizes, b_index.col_block_sizes]
        )
        cls = workload_class(sizes, 0.5 * (occ_a + occ_b))
    return table["results"].get(cls, {}).get("best")


def steady_state_time(fn, args, *, n_lo: int = 4, n_hi: int = 44,
                      reps: int = 5) -> float:
    """Marginal per-iteration device time of ``fn(*args)`` via a jitted
    dependent fori_loop at two trip counts (the bench.py methodology). The
    trip-count spread is grown adaptively until the marginal time clears
    the dispatch jitter — otherwise fast configs produce garbage rates."""
    import jax
    import jax.numpy as jnp

    a_data = args[0]

    @partial(jax.jit, static_argnames="n")
    def loop(a_data, rest, n):
        out0 = fn(a_data, *rest)  # fixes the carry shape (output != input)

        def body(i, carry):
            a_data, out = carry
            out = fn(a_data, *rest)
            a_data = a_data + out.reshape(-1)[0] * 1e-30
            return (a_data, out)

        return jax.lax.fori_loop(0, n, body, (a_data, out0))[1]

    rest = tuple(args[1:])

    def run(n):
        t0 = time.perf_counter()
        out = loop(a_data, rest, n)
        _ = float(jnp.asarray(out).ravel()[0])
        return time.perf_counter() - t0

    for attempt in range(4):
        run(n_lo)
        run(n_hi)
        los = sorted(run(n_lo) for _ in range(reps))
        his = sorted(run(n_hi) for _ in range(reps))
        lo = los[len(los) // 2]
        hi = his[len(his) // 2]
        jitter = (los[-1] - los[0]) + (his[-1] - his[0])
        delta = hi - lo
        if delta > max(2.0 * jitter, 1e-4):
            return delta / (n_hi - n_lo)
        n_hi = n_hi * 4  # too fast to resolve: widen the spread
    # still jitter-bound: report the resolution floor, not a garbage rate
    return max(delta, 1e-4) / (n_hi // 4 - n_lo)


def sweep(
    *,
    grid: Optional[Dict[str, list]] = None,
    workloads: Optional[List[str]] = None,
    drivers: Optional[List[str]] = None,
    seed: int = 0,
    verbose: bool = True,
) -> dict:
    """Time every config combo on every workload class; returns
    ``{device_kind, results: {class: {best: {...}, all: [...]}}}``."""
    import jax

    import dbcsr_tpu as dt
    from dbcsr_tpu.core.config import config_override
    from dbcsr_tpu.mm.engine import build_multiply_executor

    from dbcsr_tpu.core.config import get_config

    if grid is not None:
        names = list(grid)
        combos = [
            dict(zip(names, c))
            for c in itertools.product(*(grid[n] for n in names))
        ]
    else:  # default: per-driver sub-grids
        combos = []
        for drv, g in DRIVER_GRIDS.items():
            if drivers is not None and drv not in drivers:
                continue
            names = list(g)
            for c in itertools.product(*(g[n] for n in names)):
                combos.append({"mm_driver": drv, **dict(zip(names, c))})
    device_kind = jax.devices()[0].device_kind
    results: Dict[str, dict] = {}
    for wname in workloads or list(WORKLOADS):
        # tile_size binds at CONSTRUCTION (the matrix's store layout), so
        # the workload must be rebuilt per swept tile size — same seed so
        # every tile size sees the same logical matrices
        built: Dict[int, tuple] = {}

        def mats(ts):
            if ts not in built:
                with config_override(tile_size=ts):
                    built[ts] = WORKLOADS[wname](np.random.default_rng(seed))
            return built[ts]

        rows = []
        for cfg in combos:
            try:
                a, b = mats(cfg.get("tile_size", get_config().tile_size))
                with config_override(**cfg):
                    fn, _, eff_flops = build_multiply_executor(
                        "N", "N", a, b, driver=cfg.get("mm_driver")
                    )
                    dt_per = steady_state_time(fn, (a.data, b.data))
            except Exception as e:  # config invalid for this workload
                if verbose:
                    print(f"  {wname} {cfg}: failed ({type(e).__name__})")
                continue
            gflops = eff_flops / dt_per / 1e9
            rows.append({**cfg, "gflops": round(gflops, 2)})
            if verbose:
                print(f"  {wname} {cfg}: {gflops:9.1f} GFLOP/s")
        rows.sort(key=lambda r: -r["gflops"])
        # feature vector of the swept workload: the key for nearest-class
        # lookup at runtime (the smm_acc_predict analog)
        try:
            fa, fb = mats(get_config().tile_size)
            feats = [
                round(float(x), 4)
                for x in workload_features(fa.index, fb.index)
            ]
        except Exception:
            feats = None
        results[wname] = {
            "best": rows[0] if rows else None,
            "features": feats,
            "all": rows,
        }
    return {"device_kind": device_kind, "results": results}


def save_params(table: dict, path: Optional[str] = None) -> str:
    os.makedirs(PARAMS_DIR, exist_ok=True)
    if path is None:
        safe = table["device_kind"].replace(" ", "_").replace("/", "_")
        path = os.path.join(PARAMS_DIR, f"{safe}.json")
    with open(path, "w") as f:
        json.dump(table, f, indent=1)
    return path


def load_params(device_kind: Optional[str] = None) -> Optional[dict]:
    """Load the stored parameter table for this (or the given) device."""
    if device_kind is None:
        import jax

        device_kind = jax.devices()[0].device_kind
    safe = device_kind.replace(" ", "_").replace("/", "_")
    path = os.path.join(PARAMS_DIR, f"{safe}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def apply_tuned(
    workload: Optional[str] = None, *, table: Optional[dict] = None
) -> bool:
    """Adopt the stored winner config (the reference's runtime parameter
    lookup, ``libsmm_acc_init.cpp`` parameter-table load). Returns True if
    a tuned config was applied."""
    from dbcsr_tpu.core.config import set_config

    table = table or load_params()
    if table is None:
        return False
    classes = table["results"]
    w = workload or next(iter(classes))
    best = classes.get(w, {}).get("best")
    if not best:
        return False
    set_config(
        **{k: v for k, v in best.items() if k != "gflops"}
    )
    return True


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="dbcsr_tpu autotuner")
    p.add_argument("--out", default=None, help="output JSON path")
    p.add_argument("--workloads", nargs="*", default=None)
    p.add_argument("--drivers", nargs="*", default=None)
    p.add_argument(
        "--merge", action="store_true",
        help="merge swept classes into the existing device table",
    )
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    table = sweep(
        workloads=args.workloads, drivers=args.drivers, seed=args.seed
    )
    if args.merge:
        old = load_params(table["device_kind"])
        if old is not None:
            merged = dict(old["results"])
            for cls, res in table["results"].items():
                # a class whose sweep produced NO successful measurement
                # (every combo failed) must not
                # clobber a previously MEASURED entry with best=None —
                # stale-but-real beats fresh-but-empty
                if res.get("best") is None and merged.get(cls, {}).get(
                    "best"
                ) is not None:
                    print(f"merge: keeping existing {cls} entry "
                          "(new sweep has no successful measurement)")
                    continue
                merged[cls] = res
            table = {**old, **table, "results": merged}
    path = save_params(table, args.out)
    print(f"wrote {path}")
    for wname, res in table["results"].items():
        print(f"{wname}: best = {res['best']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
