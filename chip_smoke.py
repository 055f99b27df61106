#!/usr/bin/env python
"""End-to-end smoke of the block-sparse multiply on one GPU.

Drives the library's main path through its public entry points
(``dbcsr_tpu.perf.run_perf``, ``build_multiply_executor``, ``dt.multiply``,
``build_filtered_executor``, ``BatchedContract.contract``) at deployment
size, checks every
result against an independent numpy oracle, and times each phase:

  device    platform, device kind and count; the card's name and power
            limit from nvidia-smi
  h2o       the reference's H2O perf recipe (2208^3, 23x23 blocks, 20%
            occupancy, f64) vs a numpy f64 dense product and the recipe's
            pinned checksum
  banded    the linear-scaling SCF shape (5/13/23 blocks, a +-12-block band
            at 50% fill) at 400,000 rows, through the default, band, stack
            and XLA routes, in f32 (true f32), TF32 and f64, vs exact f64
            products of 256 sampled C block rows
  filtered  eps-filtered multiply on the banded f64 pattern: one-shot
            ``dt.multiply`` with the reference's exact rule, then the
            plan-once filtered executor
  tensor    bench.py's tall 3-index contraction through the batched
            ``contract`` vs ``numpy.einsum`` in f64
  kernels   the C-run stack kernel vs ``tile_stack_matmul_xla`` on the
            banded and a mixed-class stack; the route each earlier phase
            took, checked against the compiled program

Each phase prints one JSON line (phase, dtype, precision, oracle error,
tolerance, seconds). The last line is ``{"ok": true, "device": {...}}``.
Any failed check raises, so the script exits non-zero.

  python chip_smoke.py              one GPU, full size (needs a GPU)
  python chip_smoke.py --tiny       tiny sizes on any platform
  python chip_smoke.py --multichip  four GPUs: Cannon 2x2 and SUMMA 1x4
                                    vs the single-card executor, only
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: oracle tolerances, relative to the largest |C| of the compared window:
#: true f32 accumulates ~K roundings of 2^-24; TF32 keeps 10 mantissa bits;
#: f64 sums in another order than numpy
TOLERANCES = {"highest": 1e-5, "default": 2e-3, "float64": 1e-11}


def emit(**rec) -> None:
    print(json.dumps(rec), flush=True)


def nvidia_smi() -> str:
    """The card's name and power limit, read by a child that stays off
    JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def peak_gb() -> float:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0) / 1e9


def rel_err(got: np.ndarray, ref: np.ndarray) -> float:
    scale = float(np.max(np.abs(ref))) if ref.size else 0.0
    return float(np.max(np.abs(got - ref))) / (scale or 1.0) if ref.size else 0.0


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


@contextlib.contextmanager
def engine_routes(routes: dict, label: str):
    """Record under ``label`` how often the engine chose each product route
    (``MMStats.routes``) while the block runs."""
    from dbcsr_tpu.core.stats import get_stats

    before = dict(get_stats().routes)
    yield
    after = get_stats().routes
    routes[label] = {k: v - before.get(k, 0) for k, v in after.items()
                     if v != before.get(k, 0)}


def timed_call(fn, *args, reps: int = 3):
    """(output, median seconds of ``reps`` calls after one warm call)."""
    import jax

    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, float(np.median(ts))


# ---------------------------------------------------------------------------
# workloads
# ---------------------------------------------------------------------------

def banded_pair(nrows: int, dtype, seed: int, *, decay: bool = False):
    """bench.py's banded SCF pattern (5/13/23 blocks, |i-j| <= 12 block
    band at 50% fill) as tile stores made on the device from ``seed``.
    ``decay`` scales entries by exp(-1.5 |block distance|), so a filter
    threshold sets an effective bandwidth."""
    import jax
    import jax.numpy as jnp

    import dbcsr_tpu as dt
    from dbcsr_tpu.block.bcsr import BCSRMatrix
    from dbcsr_tpu.block.index import build_index
    from dbcsr_tpu.block.store import store_layout
    from dbcsr_tpu.block.tileops import valid_mask

    rng = np.random.default_rng(seed)
    rbs = dt.random_block_sizes(nrows, [5, 13, 23], rng)
    n = len(rbs)
    i = np.repeat(np.arange(n, dtype=np.int64), 25)
    j = i + np.tile(np.arange(-12, 13, dtype=np.int64), n)
    keep = (j >= 0) & (j < n) & (rng.random(len(j)) < 0.5)
    idx, _ = build_index(i[keep], j[keep], rbs, rbs)
    t = dt.get_config().tile_size
    lay = store_layout(idx, t)
    mask = valid_mask(idx, t).astype(dtype)
    ka, kb = jax.random.split(jax.random.PRNGKey(seed))
    shape = (lay.n_tiles, t, t)
    a_data = jax.random.normal(ka, shape, dtype) * mask
    b_data = jax.random.normal(kb, shape, dtype) * mask
    if decay:
        offs = np.concatenate(([0], np.cumsum(rbs.astype(np.int64))))
        blk_of = np.searchsorted(offs, np.arange(offs[-1]), side="right") - 1
        tc = lay.tile_coords.astype(np.int64)
        top = offs[-1] - 1
        bi = blk_of[np.minimum(tc[:, 0, None] * t + np.arange(t), top)]
        bj = blk_of[np.minimum(tc[:, 1, None] * t + np.arange(t), top)]
        dist = jnp.abs(jnp.asarray(bi)[:, :, None] - jnp.asarray(bj)[:, None, :])
        factor = jnp.exp(-1.5 * dist.astype(dtype))
        a_data = a_data * factor
        b_data = b_data * factor
    return (BCSRMatrix(name="A", index=idx, data=a_data),
            BCSRMatrix(name="B", index=idx, data=b_data))


def dense_window(store, layout, r0: int, r1: int, c0: int, c1: int,
                 host_tiles: dict) -> np.ndarray:
    """Dense [r0,r1) x [c0,c1) window of a tile store, assembled on the
    host from the tiles in ``host_tiles`` (slot -> tile; absent tiles are
    zero). Pair with :func:`fetch_tiles`."""
    t = store.shape[1]
    keys = layout.tile_keys()
    ntc = layout.ntc
    tr0, tr1 = r0 // t, (r1 - 1) // t + 1
    tc0, tc1 = c0 // t, (c1 - 1) // t + 1
    out = np.zeros(((tr1 - tr0) * t, (tc1 - tc0) * t), np.float64)
    for tr in range(tr0, tr1):
        want = tr * ntc + np.arange(tc0, tc1)
        pos = np.searchsorted(keys, want)
        for k, p in zip(want, pos):
            if p < len(keys) and keys[p] == k:
                tc = int(k % ntc)
                out[(tr - tr0) * t:(tr - tr0 + 1) * t,
                    (tc - tc0) * t:(tc - tc0 + 1) * t] = host_tiles[int(p)]
    return out[r0 - tr0 * t:r1 - tr0 * t, c0 - tc0 * t:c1 - tc0 * t]


def window_slots(layout, r0: int, r1: int, c0: int, c1: int, t: int):
    keys = layout.tile_keys()
    want = (
        np.arange(r0 // t, (r1 - 1) // t + 1)[:, None] * layout.ntc
        + np.arange(c0 // t, (c1 - 1) // t + 1)[None, :]
    ).ravel()
    pos = np.searchsorted(keys, want)
    hit = (pos < len(keys)) & (keys[np.minimum(pos, len(keys) - 1)] == want)
    return pos[hit]


def fetch_tiles(store, slots) -> dict:
    """Host copies (f64) of the given store slots, in one transfer."""
    import jax.numpy as jnp

    slots = np.unique(np.asarray(slots, dtype=np.int64))
    host = np.asarray(jnp.take(store, jnp.asarray(slots), axis=0))
    return {int(s): host[i].astype(np.float64) for i, s in enumerate(slots)}


def sample_rows(nblk: int, count: int, seed: int) -> np.ndarray:
    """``count`` block rows (all when fewer), the first and last among
    them."""
    if nblk <= count:
        return np.arange(nblk)
    rng = np.random.default_rng(seed)
    mid = rng.choice(np.arange(1, nblk - 1), count - 2, replace=False)
    return np.sort(np.concatenate(([0, nblk - 1], mid)))


def banded_oracle(a, b, c_store, c_index, rows: np.ndarray) -> float:
    """Max relative error of C = A*B over the sampled C block rows: exact
    numpy f64 products of the operand windows those rows touch, against
    the engine's C tiles. Returns max|got-ref| / max|ref| over all rows."""
    from dbcsr_tpu.block.store import store_layout

    t = a.tile
    ia, ib = a.index, b.index
    ro, co_a, co_b = ia.row_offsets, ia.col_offsets, ib.col_offsets
    c_lay = store_layout(c_index, t)
    wins = []
    need = {"a": [], "b": [], "c": []}
    for r in rows:
        r0, r1 = int(ro[r]), int(ro[r + 1])
        ks = ia.col_idx[ia.row_ptr[r]:ia.row_ptr[r + 1]]
        if len(ks) == 0:
            continue
        k0, k1 = int(co_a[ks.min()]), int(co_a[ks.max() + 1])
        js = np.concatenate([
            ib.col_idx[ib.row_ptr[k]:ib.row_ptr[k + 1]] for k in ks
        ])
        j0, j1 = int(co_b[js.min()]), int(co_b[js.max() + 1])
        wins.append((r0, r1, k0, k1, j0, j1))
        need["a"].append(window_slots(a.layout, r0, r1, k0, k1, t))
        need["b"].append(window_slots(b.layout, k0, k1, j0, j1, t))
        need["c"].append(window_slots(c_lay, r0, r1, j0, j1, t))
    ta = fetch_tiles(a.data, np.concatenate(need["a"]))
    tb = fetch_tiles(b.data, np.concatenate(need["b"]))
    tcs = fetch_tiles(c_store, np.concatenate(need["c"]))
    err = scale = 0.0
    for r0, r1, k0, k1, j0, j1 in wins:
        ref = dense_window(a.data, a.layout, r0, r1, k0, k1, ta) @ (
            dense_window(b.data, b.layout, k0, k1, j0, j1, tb)
        )
        got = dense_window(c_store, c_lay, r0, r1, j0, j1, tcs)
        err = max(err, float(np.max(np.abs(got - ref))))
        scale = max(scale, float(np.max(np.abs(ref))))
    return err / (scale or 1.0)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(tiny: bool) -> dict:
    import jax

    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    if not tiny:
        require(dev.platform == "gpu",
                f"no GPU: JAX found {dev.platform} ({dev.device_kind})")
    try:
        card = nvidia_smi()
    except (OSError, subprocess.CalledProcessError):
        if not tiny:
            raise
        card = "not available"
    print(f"card: {card}", flush=True)
    emit(phase="device", **info, card=card)
    return info


def phase_h2o(tiny: bool, seed: int) -> None:
    from dbcsr_tpu.perf import (
        dense_checksum,
        dense_host,
        make_operands,
        oracle_dense,
        parse_perf,
        run_perf,
    )

    t0 = time.perf_counter()
    cfg = parse_perf(os.path.join(HERE, "tests", "inputs", "H2O.perf"))
    full = (cfg.m, cfg.n, cfg.k)
    cfg.nrep = 3
    if tiny:
        cfg.m = cfg.n = cfg.k = 230
    res, out = run_perf(cfg, seed=seed, verbose=False, return_product=True)
    ref = oracle_dense(cfg, make_operands(cfg, seed))
    err = rel_err(dense_host(out), ref)
    tol = TOLERANCES["float64"]
    require(err <= tol, f"h2o: product error {err:.3e} > {tol:.0e}")
    cks_ref = dense_checksum(ref)
    cks_err = abs(res["checksum"] - cks_ref) / max(abs(cks_ref), 1.0)
    require(cks_err <= cfg.checksum_threshold,
            f"h2o: checksum {res['checksum']!r} vs oracle {cks_ref!r}")
    if (cfg.m, cfg.n, cfg.k) == full:
        require(res["checksum_match"], "h2o: recipe's pinned checksum")
    emit(phase="h2o", dtype="float64", precision="native f64", err=err,
         tol=tol, checksum=res["checksum"], checksum_oracle=cks_ref,
         checksum_err=cks_err, mnk=[cfg.m, cfg.n, cfg.k],
         mean_ms=res["mean_time_s"] * 1e3,
         steady_ms=res["steady_time_s"] * 1e3,
         seconds=time.perf_counter() - t0, peak_gb=peak_gb())


def run_executor(a, b, driver: str, precision: str, rows, routes: dict,
                 label: str) -> dict:
    """Build, compile, time and oracle-check one plan-once executor."""
    import jax

    from dbcsr_tpu.core.config import config_override
    from dbcsr_tpu.core.stats import get_stats
    from dbcsr_tpu.mm.engine import build_multiply_executor

    with config_override(matmul_precision=precision):
        before = dict(get_stats().routes)
        fn, c_index, flops = build_multiply_executor(
            "N", "N", a, b, driver=driver
        )
        route = [k for k, v in get_stats().routes.items()
                 if v != before.get(k, 0)]
        compiled = fn.lower(a.data, b.data).compile()
        mem = compiled.memory_analysis()
        kernel_in_program = "crun_stack_matmul" in compiled.as_text()
        c_store, sec = timed_call(fn, a.data, b.data)
    err = banded_oracle(a, b, c_store, c_index, rows)
    routes[label] = {"route": route[0], "crun_in_program": kernel_in_program}
    if jax.default_backend() == "gpu":
        # the engine's recorded choice is what the compiled program runs
        require(kernel_in_program == (route[0] == "crun"),
                f"{label}: route {route[0]} but C-run kernel in program "
                f"= {kernel_in_program}")
    return {
        "driver": driver, "route": route[0], "err": err, "ms": sec * 1e3,
        "gflops": flops / sec / 1e9,
        "temp_gb": mem.temp_size_in_bytes / 1e9,
        "argument_gb": mem.argument_size_in_bytes / 1e9,
        "output_gb": mem.output_size_in_bytes / 1e9,
    }


def phase_banded(tiny: bool, seed: int, routes: dict) -> None:
    import jax.numpy as jnp

    nrows = 4000 if tiny else 400_000
    for dtype, precision in ((jnp.float32, "highest"),
                             (jnp.float32, "default"),
                             (jnp.float64, "highest")):
        t0 = time.perf_counter()
        a, b = banded_pair(nrows, dtype, seed)
        rows = sample_rows(a.index.nblkrows, 256, seed)
        name = jnp.dtype(dtype).name
        tol = TOLERANCES["float64" if name == "float64" else precision]
        prec_label = (
            "native f64" if name == "float64"
            else {"highest": "true f32", "default": "TF32 on the GPU"}[
                precision]
        )
        recs = []
        for driver in ("auto", "band", "stack", "xla"):
            rec = run_executor(a, b, driver, precision, rows, routes,
                               f"banded/{name}/{precision}/{driver}")
            require(rec["err"] <= tol,
                    f"banded {name} {precision} {driver}: error "
                    f"{rec['err']:.3e} > {tol:.0e}")
            recs.append(rec)
        emit(phase="banded", dtype=name, precision=prec_label,
             err=max(r["err"] for r in recs), tol=tol, rows=nrows,
             a_tiles=a.layout.n_tiles, sampled_block_rows=len(rows),
             oracle="exact numpy f64 products of sampled C block rows",
             executors=recs, seconds=time.perf_counter() - t0,
             peak_gb=peak_gb())
        del a, b


def filtered_errors(full, kept_index, kept_store):
    """Check a filtered product against the unfiltered one ``full``:
    (max relative error of the kept blocks, max norm of a dropped block,
    kept count, dropped count)."""
    import jax.numpy as jnp

    import dbcsr_tpu as dt
    from dbcsr_tpu.block.store import store_layout
    from dbcsr_tpu.block.tileops import take_tiles, tile_align_map, valid_mask

    t = full.tile
    amap = tile_align_map(
        store_layout(kept_index, t).tile_keys(), full.layout.tile_keys()
    )
    ref = take_tiles(full.data, amap, t) * valid_mask(kept_index, t)
    scale = float(jnp.max(jnp.abs(ref))) or 1.0
    err = float(jnp.max(jnp.abs(kept_store - ref))) / scale
    full_keys = full.index.blk_rows.astype(np.int64) * full.index.nblkcols + (
        full.index.col_idx
    )
    kept_keys = kept_index.blk_rows.astype(np.int64) * kept_index.nblkcols + (
        kept_index.col_idx
    )
    dropped = ~np.isin(full_keys, kept_keys)
    norms = dt.block_norms(full)
    worst = float(norms[dropped].max()) if dropped.any() else 0.0
    return err, worst, int((~dropped).sum()), int(dropped.sum())


def phase_filtered(tiny: bool, seed: int) -> None:
    import jax
    import jax.numpy as jnp

    import dbcsr_tpu as dt
    from dbcsr_tpu.core.config import config_override
    from dbcsr_tpu.mm.engine import build_multiply_executor

    t0 = time.perf_counter()
    eps = 1e-6
    tol = TOLERANCES["float64"]
    a, b = banded_pair(4000 if tiny else 400_000, jnp.float64, seed,
                       decay=True)
    fn, full_index, _ = build_multiply_executor("N", "N", a, b)
    full = dt.BCSRMatrix(name="C", index=full_index, data=fn(a.data, b.data))

    with config_override(filter_mode="exact"):
        t1 = time.perf_counter()
        c1 = dt.multiply("N", "N", 1.0, a, b, filter_eps=eps)
        jax.block_until_ready(c1.data)
        oneshot_s = time.perf_counter() - t1
    err1, worst1, kept1, dropped1 = filtered_errors(full, c1.index, c1.data)
    require(err1 <= tol, f"filtered one-shot: kept error {err1:.3e}")
    # f32 block norms: the threshold rule holds to f32 rounding
    require(worst1 < eps * (1 + 1e-3),
            f"filtered one-shot: dropped block of norm {worst1:.3e}")
    require(dropped1 > 0 and kept1 > 0, "filtered: nothing dropped or kept")

    ex = dt.build_filtered_executor("N", "N", a, b, eps)
    (c2, keep, _), step_s = timed_call(ex.step, a.data, b.data)
    compact = ex.compact(c2, keep)
    err2, worst2, kept2, dropped2 = filtered_errors(
        full, compact.index, compact.data
    )
    require(err2 <= tol, f"filtered executor: kept error {err2:.3e}")
    require(worst2 < eps * (1 + 1e-3),
            f"filtered executor: dropped block of norm {worst2:.3e}")
    emit(phase="filtered", dtype="float64", precision="native f64",
         err=max(err1, err2), tol=tol, eps=eps,
         oneshot={"kept": kept1, "dropped": dropped1,
                  "max_dropped_norm": worst1, "ms": oneshot_s * 1e3},
         executor={"kept": kept2, "dropped": dropped2,
                   "max_dropped_norm": worst2, "ms": step_s * 1e3},
         seconds=time.perf_counter() - t0, peak_gb=peak_gb())


def tensor_operands(tiny: bool, seed: int):
    """bench.py's tensor config (C(i,j,l) = sum_k A(i,j,k) B(k,l), tall i
    of 5/13 blocks, 10 blocks of 8 on j/k/l) in f64, built in the
    contraction layouts."""
    import dbcsr_tpu as dt
    from dbcsr_tpu.tensors import TensorBuilder, contraction_layouts

    rng = np.random.default_rng(seed)

    def rand_tensor(block_sizes, occ, name, mapping):
        bs = [np.asarray(v, dtype=np.int32) for v in block_sizes]
        builder = TensorBuilder(bs, mapping, name=name, dtype=np.float64)
        nbpd = [len(v) for v in bs]
        for flat in np.flatnonzero(rng.random(int(np.prod(nbpd))) < occ):
            bi = np.unravel_index(flat, nbpd)
            shp = tuple(int(bs[d][bi[d]]) for d in range(len(bs)))
            builder.put_block(bi, rng.standard_normal(shp))
        return builder.finalize()

    i_bs = dt.random_block_sizes(200 if tiny else 2000, [5, 13], rng)
    e = np.full(10, 8, dtype=np.int32)
    kw = dict(contract_1=(2,), notcontract_1=(0, 1),
              contract_2=(0,), notcontract_2=(1,))
    la, lb, _ = contraction_layouts(3, (2,), (0, 1), 2, (0,), (1,))
    a = rand_tensor([i_bs, e, e], 0.15, "T3", la)
    b = rand_tensor([e, e], 0.6, "M2", lb)
    return a, b, kw


def phase_tensor(tiny: bool, seed: int) -> None:
    """The contraction through the batched form bench.py measures
    (``BatchedContract.contract``, the reference's
    ``dbcsr_t_batched_contract_*``): the one-shot ``dt.contract`` splits
    this tall operand into ~1,300 TAS groups and spends minutes in host
    work at this size (PERF.md)."""
    from dbcsr_tpu.tensors import BatchedContract

    t0 = time.perf_counter()
    a, b, kw = tensor_operands(tiny, seed)
    with BatchedContract() as bc:
        np.asarray(bc.contract(a, b, **kw).to_dense())  # plan + compile
        t1 = time.perf_counter()
        got = np.asarray(bc.contract(a, b, **kw).to_dense())
        call_s = time.perf_counter() - t1
    ref = np.einsum("ijk,kl->ijl", np.asarray(a.to_dense()),
                    np.asarray(b.to_dense()))
    err = rel_err(got, ref)
    tol = TOLERANCES["float64"]
    require(got.shape == ref.shape, f"tensor: shape {got.shape}")
    require(err <= tol, f"tensor: error {err:.3e} > {tol:.0e}")
    emit(phase="tensor", dtype="float64", precision="native f64", err=err,
         tol=tol, shape=list(ref.shape), call_ms=call_s * 1e3,
         seconds=time.perf_counter() - t0, peak_gb=peak_gb())


def mixed_stack(tiny: bool, seed: int):
    """A mixed-class stack (5/13/23 blocks at 20% occupancy, bench.py's
    mixed config): every tile is occupied, so each C tile's run spans
    the whole K dimension."""
    import dbcsr_tpu as dt

    rng = np.random.default_rng(seed)
    rbs = dt.random_block_sizes(600 if tiny else 6000, [5, 13, 23], rng)
    a = dt.random_matrix(rbs, rbs, 0.2, rng, dtype=np.float32)
    b = dt.random_matrix(rbs, rbs, 0.2, rng, dtype=np.float32)
    return a, b


def phase_kernels(tiny: bool, seed: int, routes: dict) -> None:
    import jax
    import jax.numpy as jnp

    from dbcsr_tpu.mm.kernels import tile_stack_matmul_crun, tile_stack_matmul_xla
    from dbcsr_tpu.mm.tileplan import plan_tile_stacks_stores

    t0 = time.perf_counter()
    interpret = jax.default_backend() != "gpu"
    stacks = {"banded": banded_pair(4000 if tiny else 400_000, jnp.float32,
                                    seed),
              "mixed": mixed_stack(tiny, seed)}
    recs = []
    for name, (a, b) in stacks.items():
        la, lb = a.layout, b.layout
        plan = plan_tile_stacks_stores(
            la.tile_coords, (la.ntr, la.ntc), lb.tile_coords, (lb.ntr, lb.ntc)
        )
        stack, n_c = plan.stack, plan.n_c_tiles
        if interpret:  # the interpreter is slow: the first 32 C runs
            n_c = min(n_c, 32)
            stack = stack[stack[:, 0] < n_c]
        st = jnp.asarray(stack)
        ref = tile_stack_matmul_xla(a.data, b.data, st, n_c_tiles=n_c,
                                    precision="highest")
        for precision in ("highest", "default"):
            xla = jax.jit(lambda x, y, p=precision: tile_stack_matmul_xla(
                x, y, st, n_c_tiles=n_c, precision=p))
            crun = jax.jit(lambda x, y, p=precision: tile_stack_matmul_crun(
                x, y, stack, n_c_tiles=n_c, precision=p,
                interpret=interpret))
            _, t_xla = timed_call(xla, a.data, b.data)
            got, t_crun = timed_call(crun, a.data, b.data)
            err = rel_err(np.asarray(got), np.asarray(ref))
            tol = TOLERANCES[precision]
            require(err <= tol, f"kernels {name} {precision}: error "
                                f"{err:.3e} vs xla highest > {tol:.0e}")
            recs.append({"stack": name, "entries": int(len(stack)),
                         "c_tiles": int(n_c), "precision": precision,
                         "crun_ms": t_crun * 1e3, "xla_ms": t_xla * 1e3,
                         "err_vs_xla_highest": err, "tol": tol})
    emit(phase="kernels", dtype="float32", precision="true f32 and TF32",
         err=max(r["err_vs_xla_highest"] for r in recs),
         tol=TOLERANCES["default"], interpret=interpret, timings=recs,
         routes=routes, seconds=time.perf_counter() - t0, peak_gb=peak_gb())


def phase_multichip(tiny: bool, seed: int) -> None:
    """Cannon on a 2x2 grid and SUMMA on 1x4, each through
    ``dt.multiply(dist=...)``, vs the single-card executor on card 0."""
    import jax
    import jax.numpy as jnp

    import dbcsr_tpu as dt
    from dbcsr_tpu.block.store import store_layout
    from dbcsr_tpu.block.tileops import take_tiles, tile_align_map
    from dbcsr_tpu.dist.distribution import tile_aligned_dist
    from dbcsr_tpu.dist.grid import ProcessGrid
    from dbcsr_tpu.mm.engine import build_multiply_executor

    require(len(jax.devices()) >= 4, "multichip: needs 4 devices")
    nrows = 4000 if tiny else 400_000
    a, b = banded_pair(nrows, jnp.float32, seed)
    fn, c_index, _ = build_multiply_executor("N", "N", a, b)
    single = jax.block_until_ready(fn(a.data, b.data))
    t = a.tile
    for algo, (p, q) in (("cannon", (2, 2)), ("summa", (1, 4))):
        t0 = time.perf_counter()
        grid = ProcessGrid.make(p, q)
        dist = tile_aligned_dist(grid, a.index.row_block_sizes,
                                 a.index.col_block_sizes, t)
        c = dt.multiply("N", "N", 1.0, a, b, dist=dist)
        jax.block_until_ready(c.data)
        sec = time.perf_counter() - t0
        devices = {d.id for d in c.data.sharding.device_set}
        mesh_devices = len(grid.mesh.devices.ravel())
        amap = tile_align_map(store_layout(c.index, t).tile_keys(),
                              store_layout(c_index, t).tile_keys())
        ref = np.asarray(take_tiles(single, amap, t))
        err = rel_err(np.asarray(c.data), ref)
        tol = TOLERANCES["highest"]
        require(mesh_devices == 4, f"{algo}: mesh of {mesh_devices}")
        require(err <= tol, f"{algo}: error {err:.3e} vs single card")
        emit(phase="multichip", algo=algo, grid=[p, q], dtype="float32",
             precision="true f32", err=err, tol=tol, rows=nrows,
             mesh_devices=mesh_devices, result_devices=sorted(devices),
             result_sharding=str(c.data.sharding), seconds=sec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiny", action="store_true",
                    help="tiny sizes on any platform (CPU rehearsal)")
    ap.add_argument("--multichip", action="store_true",
                    help="only the 4-card Cannon/SUMMA phase")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    import dbcsr_tpu as dt
    from dbcsr_tpu.core.machine import setup_compile_cache

    setup_compile_cache()
    dt.init_lib()
    info = phase_device(args.tiny)
    if args.multichip:
        phase_multichip(args.tiny, args.seed)
    else:
        routes: dict = {}
        with engine_routes(routes, "h2o"):
            phase_h2o(args.tiny, args.seed)
        phase_banded(args.tiny, args.seed, routes)
        with engine_routes(routes, "filtered"):
            phase_filtered(args.tiny, args.seed)
        with engine_routes(routes, "tensor"):
            phase_tensor(args.tiny, args.seed)
        phase_kernels(args.tiny, args.seed, routes)
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
