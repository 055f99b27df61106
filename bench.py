#!/usr/bin/env python
"""Throughput benchmark: one workload config per process, one JSON line.

Default workload (``python bench.py`` = ``block23``): dense-blocked BCSR
matrices with uniform 23x23 blocks (128 block rows/cols -> 2944x2944),
C = A*B through the engine's plan-once executor
(``build_multiply_executor`` — the steady-state form every iterative
caller uses). Effective flops are counted at USER-BLOCK granularity
(2*sum(m*n*k) over block triples), exactly the reference's flop accounting
(``src/mm/dbcsr_mm.F`` flop counters).

Secondary configs (``python bench.py sparse5|mixed|banded|clustered``)
cover the other workload shapes (10%-occupancy 5x5 blocks, mixed 5/13/23
at 20%, a banded 40k-row linear-scaling SCF shape, and a clustered shape
whose scrambled numbering is recovered by ``locality_block_permutation``).
``filtered`` (eps-filtered multiply with on-the-fly truncation, per-call
end-to-end accounting) and ``tensor`` (tall 3-index contraction through
BatchedContract) complete the set.

Timing: run the executor inside a jitted dependent fori_loop at two trip
counts, force a value readback, and take the marginal time per iteration
— device steady-state time without dispatch.

Each record names the device it ran on (platform, ``device_kind``, device
count) and the matmul precision. ``DBCSR_BENCH_TINY=1`` shrinks every
workload ~20x for a code-path smoke on any platform; without it the run
needs a GPU and fails elsewhere.
"""
import json
import os
import subprocess
import sys
import time
from functools import partial

import numpy as np

_METRIC_BY_CONFIG = {
    "block23": "block23_mm_throughput",
    "sparse5": "sparse5_mm_throughput",
    "mixed": "mixed_mm_throughput",
    "clustered": "clustered_mm_throughput",
    "banded": "banded_mm_throughput",
    "filtered": "filtered_mm_throughput",
    "tensor": "tensor_contract_throughput",
}


#: published dense peaks per device kind (NVIDIA H100 data sheet, SXM
#: part, without sparsity; they assume the 700 W power limit)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "f32_flops": 67e12,
        "f64_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def device_peaks(device_kind: str) -> dict:
    """The peak table's entry for ``device_kind``; an unknown device is an
    error, never a default."""
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {device_kind!r}")
    return PEAKS[device_kind]


def _device_record(precision: str) -> dict:
    import jax

    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "matmul_precision": precision,
        "tiny": _TINY,
    }


# DBCSR_BENCH_TINY=1 shrinks every workload ~20x and the timing loops to
# a few reps: a CPU-feasible smoke of each config's full code path (the
# suite runs all of them), never a perf number. _sz scales a row count
# with a floor that keeps the pattern's character (bands, tile packing).
_TINY = os.environ.get("DBCSR_BENCH_TINY") == "1"


def _sz(n, floor=64):
    return max(floor, n // 20) if _TINY else n


def _per_call_median(call, sync, warmup=2, reps=9):
    """Median END-TO-END per-call wall time: host planning + dispatch +
    compute. The one-shot configs below replan every call by design
    (filtered patterns depend on data norms; that IS the workload), so
    the marginal-time loop methodology does not apply — this mirrors the
    reference perf driver's per-rep accounting, which likewise includes
    MPI and index assembly (``tests/dbcsr_performance_multiply.F``)."""
    if _TINY:
        warmup, reps = 1, 3
    for _ in range(warmup):
        sync(call())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sync(call())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _emit(metric, gflops, vs, **extra):
    print(json.dumps({
        "metric": metric,
        "value": round(gflops, 1),
        "unit": "GFLOP/s",
        "vs_baseline": None if vs is None else round(vs, 3),
        **_device_record("default"),
        **extra,
    }))


def _bench_filtered(rng):
    """BASELINE config 3: epsilon-filtered multiply — the linear-scaling
    SCF pattern — measured the way the SCF loop actually runs: operand
    DATA CHANGES EVERY CALL over a fixed pattern. Banded operands whose
    block magnitudes decay away from the diagonal, so ``filter_eps``
    genuinely truncates the product's far-band tail.

    Headline: the device-resident ``FilteredExecutor`` (mm/filtered.py —
    superset product + on-device norms/threshold/mask, zero host work
    per call) in a jitted loop cycling 4 independent data variants, so
    no content cache can flatter the number (round-4 Weak #3).
    ``vs_baseline`` is the FILTERING OVERHEAD FACTOR: executor rate /
    unfiltered plan-once executor rate on the SAME pattern (round-4
    Next #7 — externally meaningful, not a self-referential ratio).
    Extra fields record the one-shot ``dt.multiply`` end-to-end path,
    both data-static (the round-4 metric) and data-varying (the honest
    naive-caller cost). Reference analog: ``dbcsr_multiply(...,
    filter_eps)`` inside CP2K's linear-scaling SCF
    (``src/mm/dbcsr_mm_cannon.F:1042-1113`` per-row thresholds)."""
    import jax
    import jax.numpy as jnp

    import dbcsr_tpu as dt
    from dbcsr_tpu.block.bcsr import BCSRMatrix
    from dbcsr_tpu.block.index import build_index
    from dbcsr_tpu.block.store import store_layout
    from dbcsr_tpu.block.tileops import valid_mask

    rbs = dt.random_block_sizes(_sz(12000), [5, 13, 23], rng)
    n = len(rbs)
    i = np.repeat(np.arange(n, dtype=np.int64), 25)
    j = i + np.tile(np.arange(-12, 13, dtype=np.int64), n)
    keep = (j >= 0) & (j < n) & (rng.random(len(j)) < 0.5)
    idx, _ = build_index(i[keep], j[keep], rbs, rbs)
    lay = store_layout(idx, 128)
    data = jax.random.normal(
        jax.random.PRNGKey(0), (lay.n_tiles, 128, 128), jnp.float32
    ) * valid_mask(idx, 128)
    n_var = 4  # independent A-data variants cycled per iteration
    # block-granular off-diagonal decay exp(-1.5*|bi-bj|), applied
    # element-wise through the block-of-element-row maps: eps then sets
    # an effective bandwidth — calibrated so ~20% of product flops are
    # skipped on the fly and ~half of C's far-band blocks fall to the
    # final Frobenius filter (the linear-scaling density-matrix shape)
    offs = np.concatenate(([0], np.cumsum(rbs.astype(np.int64))))
    nelem = int(offs[-1])
    blk_of = np.searchsorted(offs, np.arange(nelem), side="right") - 1
    tc = lay.tile_coords
    er = np.minimum(
        tc[:, 0, None].astype(np.int64) * 128 + np.arange(128), nelem - 1
    )
    ec = np.minimum(
        tc[:, 1, None].astype(np.int64) * 128 + np.arange(128), nelem - 1
    )
    bi, bj = blk_of[er], blk_of[ec]
    decay = jnp.exp(
        -1.5
        * jnp.abs(
            jnp.asarray(bi)[:, :, None] - jnp.asarray(bj)[:, None, :]
        ).astype(jnp.float32)
    )
    data = data * decay
    a = BCSRMatrix(name="A", index=idx, data=data)
    b = BCSRMatrix(name="B", index=idx, data=data * 0.5)
    eps = 1e-5

    # ---- headline: FilteredExecutor, data varying every call ----------
    ex = dt.build_filtered_executor("N", "N", a, b, eps)
    vmask = valid_mask(idx, 128)
    decay_d = jnp.asarray(decay)
    a_vars = jnp.stack([
        jax.random.normal(
            jax.random.PRNGKey(100 + v), (lay.n_tiles, 128, 128),
            jnp.float32,
        ) * vmask * decay_d
        for v in range(n_var)
    ])

    # the variants must produce genuinely different keep sets, or the
    # "data-varying" label is hollow — assert it before timing
    keeps = [np.asarray(ex.step(a_vars[v], b.data)[1]) for v in range(2)]
    assert not np.array_equal(keeps[0], keeps[1]), (
        "filtered bench: data variants produced identical keep sets"
    )
    kept_frac = float(np.mean([k.mean() for k in keeps]))

    @partial(jax.jit, static_argnames="n")
    def loop_step(a_stack, b_data, n):
        def body(it, carry):
            a_stack, acc = carry
            a_i = jax.lax.dynamic_index_in_dim(
                a_stack, it % n_var, axis=0, keepdims=False
            )
            c, k, _ = ex.step(a_i, b_data)
            # fold a result-dependent epsilon back into the carry so no
            # iteration can be elided
            return (a_stack + c.reshape(-1)[0] * 1e-30, acc + jnp.sum(k))

        return jax.lax.fori_loop(0, n, body, (a_stack, jnp.float32(0)))[1]

    def run(fn, n, *args):
        t0 = time.perf_counter()
        out = fn(*args, n)
        _ = float(jnp.asarray(out).ravel()[0])
        return time.perf_counter() - t0

    n_lo, n_hi = (2, 8) if _TINY else (5, 45)
    run(loop_step, n_lo, a_vars, b.data)
    run(loop_step, n_hi, a_vars, b.data)
    lo = float(np.median([run(loop_step, n_lo, a_vars, b.data) for _ in range(5)]))
    hi = float(np.median([run(loop_step, n_hi, a_vars, b.data) for _ in range(5)]))
    # clamp: at TINY scale the marginal time is noise-dominated and can
    # come out <= 0; TINY is a code-path smoke, never a perf number
    per = max((hi - lo) / (n_hi - n_lo), 1e-7)
    gflops = ex.eff_flops / per / 1e9

    # ---- baseline: the UNFILTERED plan-once executor, same pattern ----
    from dbcsr_tpu.mm.engine import build_multiply_executor

    fn_plain, _, _ = build_multiply_executor("N", "N", a, b)

    @partial(jax.jit, static_argnames="n")
    def loop_plain(a_stack, b_data, n):
        def body(it, carry):
            a_stack, acc = carry
            a_i = jax.lax.dynamic_index_in_dim(
                a_stack, it % n_var, axis=0, keepdims=False
            )
            c = fn_plain(a_i, b_data)
            return (a_stack + c.reshape(-1)[0] * 1e-30, acc + c.reshape(-1)[0])

        return jax.lax.fori_loop(0, n, body, (a_stack, jnp.float32(0)))[1]

    run(loop_plain, n_lo, a_vars, b.data)
    run(loop_plain, n_hi, a_vars, b.data)
    lo_p = float(np.median([run(loop_plain, n_lo, a_vars, b.data) for _ in range(5)]))
    hi_p = float(np.median([run(loop_plain, n_hi, a_vars, b.data) for _ in range(5)]))
    per_plain = max((hi_p - lo_p) / (n_hi - n_lo), 1e-7)

    # ---- extras: the one-shot dt.multiply end-to-end path -------------
    # the varying leg sees a DISTINCT matrix on every call (warmup
    # included) so no content-keyed cache can absorb the host work —
    # this is the true naive-caller cold cost (round-4 Weak #3)
    n_one = 2 if _TINY else 6
    a_mats = [
        BCSRMatrix(
            name=f"A{v}",
            index=idx,
            data=(
                a_vars[v] if v < n_var else
                jax.random.normal(
                    jax.random.PRNGKey(200 + v),
                    (lay.n_tiles, 128, 128), jnp.float32,
                ) * vmask * decay_d
            ),
        )
        for v in range(n_one)
    ]
    state = {"i": 0}

    def call_varying():
        m = a_mats[state["i"] % len(a_mats)]
        state["i"] += 1
        return dt.multiply("N", "N", 1.0, m, b, filter_eps=eps,
                           return_flops=True)

    def call_static():
        return dt.multiply("N", "N", 1.0, a, b, filter_eps=eps,
                           return_flops=True)

    def sync(out):
        jax.block_until_ready(out[0].data)

    per_one_var = _per_call_median(
        call_varying, sync, warmup=1, reps=n_one - 1
    )
    per_one_static = _per_call_median(call_static, sync, warmup=1, reps=5)
    _, flops_host = call_static()

    _emit(
        "filtered_mm_throughput", gflops,
        per_plain / per,  # filtering overhead factor (<= ~1)
        ms_per_call=round(per * 1e3, 2),
        ms_per_call_unfiltered=round(per_plain * 1e3, 2),
        c_blocks_kept=round(kept_frac, 3),
        filtered_flop_fraction=round(flops_host / ex.eff_flops, 3),
        oneshot_ms_data_varying=round(per_one_var * 1e3, 1),
        oneshot_ms_data_static=round(per_one_static * 1e3, 1),
    )


def _bench_tensor(rng):
    """BASELINE config 4: 3-index contraction on a tall-and-skinny
    block-sparse tensor — C(i,j,l) = sum_k A(i,j,k) * B(k,l), long i
    (the ``dbcsr_tensor_unittest`` shape class). Steady state through
    ``BatchedContract`` (the reference's ``dbcsr_t_batched_contract_*``
    state machine): layout alignment + TAS split decisions are cached,
    each call pays fold + per-subgroup multiply dispatch."""
    import jax

    import dbcsr_tpu as dt
    from dbcsr_tpu.mm.plan import symbolic_product
    from dbcsr_tpu.tensors import BatchedContract, NDMapping, TensorBuilder

    def rand_tensor(block_sizes, occ, name, mapping=None):
        bs = [np.asarray(v, dtype=np.int32) for v in block_sizes]
        builder = TensorBuilder(bs, mapping, name=name, dtype=np.float32)
        nbpd = [len(v) for v in bs]
        total = int(np.prod(nbpd))
        for flat in np.flatnonzero(rng.random(total) < occ):
            bi = np.unravel_index(flat, nbpd)
            shp = tuple(int(bs[d][bi[d]]) for d in range(len(bs)))
            builder.put_block(bi, rng.standard_normal(shp))
        return builder.finalize()

    i_bs = dt.random_block_sizes(_sz(2000), [5, 13], rng)  # tall axis
    j_bs = np.full(10, 8, dtype=np.int32)
    k_bs = np.full(10, 8, dtype=np.int32)
    l_bs = np.full(10, 8, dtype=np.int32)

    kw = dict(
        contract_1=(2,), notcontract_1=(0, 1),
        contract_2=(0,), notcontract_2=(1,),
    )
    # operands built IN the contraction layouts (`contraction_layouts` —
    # the documented batched-contraction workflow, the analog of the
    # reference's cached mm_storage in dbcsr_tas_batched_mm): the
    # steady-state loop then runs refold-free. Tensors left in other
    # layouts pay an element-granular refold gather PER OPERAND PER CALL
    # (the store.py gather-granularity wall); that cost is reported
    # separately below.
    from dbcsr_tpu.tensors import contraction_layouts

    la, lb, _ = contraction_layouts(3, kw["contract_1"],
                                    kw["notcontract_1"], 2,
                                    kw["contract_2"], kw["notcontract_2"])
    a = rand_tensor([i_bs, j_bs, k_bs], 0.15, "T3", mapping=la)
    b = rand_tensor([k_bs, l_bs], 0.6, "M2", mapping=lb)
    # effective flops from the folded 2-D symbolic product (block
    # granularity is preserved by the fold); pure host metadata, unlike
    # a one-shot contract() whose TAS split estimation is setup-heavy
    a2 = a.with_layout(NDMapping(3, (0, 1), (2,)))
    b2 = b.with_layout(NDMapping(2, (0,), (1,)))
    am = getattr(a2.matrix, "matrix", a2.matrix)
    bm = getattr(b2.matrix, "matrix", b2.matrix)
    flops = symbolic_product(am.index, False, bm.index, False).eff_flops

    # baseline: the SAME product as a plain folded-2D plan-once executor;
    # vs_baseline is the TENSOR-LAYER OVERHEAD FACTOR — what fraction of
    # the raw folded multiply's rate survives the nd fold/alignment
    # machinery
    import jax.numpy as jnp

    from dbcsr_tpu.mm.engine import build_multiply_executor

    fn2d, _, _ = build_multiply_executor("N", "N", am, bm)

    @partial(jax.jit, static_argnames="n")
    def loop_2d(ad, bd, n):
        def body(i, carry):
            ad, acc = carry
            cd = fn2d(ad, bd)
            return (ad + cd.reshape(-1)[0] * 1e-30, acc + cd.reshape(-1)[1])

        return jax.lax.fori_loop(0, n, body, (ad, jnp.float32(0)))[1]

    def run_2d(n):
        t0 = time.perf_counter()
        out = loop_2d(am.data, bm.data, n)
        _ = float(jnp.asarray(out))
        return time.perf_counter() - t0

    n2_lo, n2_hi = (2, 8) if _TINY else (10, 110)
    run_2d(n2_lo)
    run_2d(n2_hi)
    lo2 = float(np.median([run_2d(n2_lo) for _ in range(5)]))
    hi2 = float(np.median([run_2d(n2_hi) for _ in range(5)]))
    per_2d = max((hi2 - lo2) / (n2_hi - n2_lo), 1e-7)

    # batch-amortized end-to-end timing: N back-to-back calls with ONE
    # forced readback at the end keep every call's host work in the
    # measurement — the batched-contraction usage pattern itself
    # (``dbcsr_t_batched_contract_*``)
    with BatchedContract() as bc:
        def readback(out):
            m = out.matrix
            m = getattr(m, "matrix", m)  # TAS wrapper or plain BCSR
            return float(np.asarray(jax.device_get(m.data)).ravel()[0])

        def run_batch(ncalls):
            t0 = time.perf_counter()
            out = None
            for _ in range(ncalls):
                out = bc.contract(a, b, **kw)
            readback(out)
            return time.perf_counter() - t0

        # wide spread: the batch delta must dwarf the single readback
        n_lo, n_hi = (1, 3) if _TINY else (10, 210)
        run_batch(n_lo)
        run_batch(n_hi)
        lo = float(np.median([run_batch(n_lo) for _ in range(5)]))
        hi = float(np.median([run_batch(n_hi) for _ in range(5)]))
        per = max((hi - lo) / (n_hi - n_lo), 1e-7)
    gflops = flops / per / 1e9

    # the cost a NON-prepared layout would add per operand per call: one
    # element-granular refold gather (the store.py granularity wall)
    def time_refold():
        flip = NDMapping(3, (2,), (0, 1))
        t0 = time.perf_counter()
        af = a.with_layout(flip)
        m = getattr(af.matrix, "matrix", af.matrix)
        _ = float(np.asarray(jax.device_get(m.data)).ravel()[0])
        return time.perf_counter() - t0

    time_refold()  # warm (host map build + compile)
    per_refold = min(time_refold() for _ in range(3))

    _emit(
        "tensor_contract_throughput", gflops,
        per_2d / per,  # tensor-layer overhead factor (<= ~1)
        ms_per_call=round(per * 1e3, 2),
        ms_per_call_folded2d=round(per_2d * 1e3, 2),
        ms_refold_per_operand=round(per_refold * 1e3, 2),
    )


def main():
    config = sys.argv[1] if len(sys.argv) > 1 else "block23"
    import jax
    import jax.numpy as jnp

    import dbcsr_tpu as dt
    from dbcsr_tpu.mm.engine import build_multiply_executor

    from dbcsr_tpu.core.machine import setup_compile_cache

    setup_compile_cache()
    if not _TINY and jax.devices()[0].platform != "gpu":
        raise SystemExit(
            f"bench.py measures on a GPU; found {jax.devices()[0].platform} "
            "(DBCSR_BENCH_TINY=1 runs a code-path smoke anywhere)"
        )
    dt.init_lib(enable_x64=False)
    # single-pass precision for the throughput benchmark: TF32 for f32
    # operands on the GPU ('highest' is the accuracy default)
    dt.set_config(matmul_precision="default")

    rng = np.random.default_rng(0)
    if config == "filtered":
        _bench_filtered(rng)
        return
    if config == "tensor":
        _bench_tensor(rng)
        return
    metric = "block23_mm_throughput"
    if config == "block23":
        # dense-blocked 23^3 (the headline dense-GEMM config)
        rbs = np.full(_sz(128, 16), 23, dtype=np.int32)
        a = dt.random_matrix(rbs, rbs, 1.0, rng, dtype=np.float32, name="A")
        b = dt.random_matrix(rbs, rbs, 1.0, rng, dtype=np.float32, name="B")
    elif config == "sparse5":
        # BASELINE config 1: 1000x1000, 5x5 blocks, ~10% occupancy scaled 8x
        metric = "sparse5_mm_throughput"
        rbs = np.full(_sz(1600), 5, dtype=np.int32)
        a = dt.random_matrix(rbs, rbs, 0.10, rng, dtype=np.float32, name="A")
        b = dt.random_matrix(rbs, rbs, 0.10, rng, dtype=np.float32, name="B")
    elif config == "mixed":
        # BASELINE config 2: mixed 5/13/23 blocks, 20% occupancy
        metric = "mixed_mm_throughput"
        rbs = dt.random_block_sizes(_sz(6000), [5, 13, 23], rng)
        a = dt.random_matrix(rbs, rbs, 0.2, rng, dtype=np.float32, name="A")
        b = dt.random_matrix(rbs, rbs, 0.2, rng, dtype=np.float32, name="B")
    elif config == "clustered":
        # linear-scaling SCF shape #2: near-sighted exponential-decay
        # coupling along a hidden 1-D chain, block numbering SCRAMBLED by
        # a random permutation (the atom numbering does not expose the
        # locality). ``locality_block_permutation`` recovers the hidden
        # axis before the tile stores are built; throughput only.
        metric = "clustered_mm_throughput"
        from dbcsr_tpu.block.bcsr import BCSRMatrix
        from dbcsr_tpu.block.index import build_index
        from dbcsr_tpu.block.store import store_layout
        from dbcsr_tpu.block.tileops import valid_mask
        from dbcsr_tpu.mm.reorder import locality_block_permutation

        rbs = dt.random_block_sizes(_sz(24000), [5, 13, 23], rng)
        n = len(rbs)
        dmax = 15
        i = np.repeat(np.arange(n, dtype=np.int64), 2 * dmax + 1)
        off = np.tile(np.arange(-dmax, dmax + 1, dtype=np.int64), n)
        j = i + off
        # P(coupling at chain distance d) = exp(-d/4), diagonal always
        keep = (
            (j >= 0)
            & (j < n)
            & (rng.random(len(j)) < np.exp(-np.abs(off) / 4.0))
        )
        sig = rng.permutation(n).astype(np.int64)
        rbs_s = np.empty(n, np.int32)
        rbs_s[sig] = rbs  # sizes follow their blocks through the scramble

        def store_mat(rows, cols, sizes, name, scale=1.0):
            idx, _ = build_index(rows, cols, sizes, sizes)
            lay = store_layout(idx, 128)
            data = jax.random.normal(
                jax.random.PRNGKey(0), (lay.n_tiles, 128, 128), jnp.float32
            )
            data = data * scale * valid_mask(idx, 128)
            return BCSRMatrix(name=name, index=idx, data=data)

        sr, sc = sig[i[keep]], sig[j[keep]]
        idx0, _ = build_index(sr, sc, rbs_s, rbs_s)  # scrambled numbering
        perm = locality_block_permutation(idx0)
        if perm is None:
            raise SystemExit(
                "clustered bench: locality_block_permutation declined the "
                "pattern (degenerate input) — the workload generator is "
                "supposed to produce a reorderable banded structure"
            )
        pm, _, _ = perm
        rbs_r = np.empty(n, np.int32)
        rbs_r[pm[sig]] = rbs
        a = store_mat(pm[sr], pm[sc], rbs_r, "A")  # RCM-recovered numbering
        b = store_mat(pm[sr], pm[sc], rbs_r, "B", 0.5)
    elif config == "banded":
        # linear-scaling SCF shape: banded 40k block rows (stack path);
        # data built directly in store form (construction shortcut)
        metric = "banded_mm_throughput"
        from dbcsr_tpu.block.bcsr import BCSRMatrix
        from dbcsr_tpu.block.index import build_index
        from dbcsr_tpu.block.store import store_layout
        from dbcsr_tpu.block.tileops import valid_mask

        rbs = dt.random_block_sizes(_sz(40000), [5, 13, 23], rng)
        n = len(rbs)
        i = np.repeat(np.arange(n, dtype=np.int64), 25)
        j = i + np.tile(np.arange(-12, 13, dtype=np.int64), n)
        keep = (j >= 0) & (j < n) & (rng.random(len(j)) < 0.5)
        idx, _ = build_index(i[keep], j[keep], rbs, rbs)
        lay = store_layout(idx, 128)
        data = jax.random.normal(
            jax.random.PRNGKey(0), (lay.n_tiles, 128, 128), jnp.float32
        )
        data = data * valid_mask(idx, 128)
        a = BCSRMatrix(name="A", index=idx, data=data)
        b = BCSRMatrix(name="B", index=idx, data=data * 0.5)
    else:
        raise SystemExit(f"unknown bench config {config!r}")

    def measure(fn, c_index, ma, mb, n_lo=10, n_hi=210):
        if _TINY:
            n_lo, n_hi = 2, 8
        from dbcsr_tpu.block.store import store_layout

        chain = np.array_equal(
            store_layout(c_index, ma.tile).tile_keys(),
            ma.layout.tile_keys(),
        )

        @partial(jax.jit, static_argnames="n")
        def loop(a_data, b_data, n):
            if chain:
                # C := A·B, A ← C each iteration (C's store layout equals
                # A's): the real iterative-caller shape (SCF / matrix
                # powers) with a true loop-carried dependency.
                def body(i, a_data):
                    return fn(a_data, b_data)

                return jax.lax.fori_loop(0, n, body, a_data)

            out0 = fn(a_data, b_data)

            def body(i, carry):
                a_data, out = carry
                out = fn(a_data, b_data)
                return (a_data + out.reshape(-1)[0] * 1e-30, out)

            return jax.lax.fori_loop(0, n, body, (a_data, out0))[1]

        def run(n):
            t0 = time.perf_counter()
            out = loop(ma.data, mb.data, n)
            _ = float(jnp.asarray(out).ravel()[0])  # force full execution
            return time.perf_counter() - t0

        # warm both trip counts (compile), then take medians; trip counts
        # high enough that the marginal time dwarfs dispatch jitter
        run(n_lo)
        run(n_hi)
        lo = float(np.median([run(n_lo) for _ in range(5)]))
        hi = float(np.median([run(n_hi) for _ in range(5)]))
        return (hi - lo) / (n_hi - n_lo)

    fn, c_index, eff_flops = build_multiply_executor("N", "N", a, b)
    per_iter = measure(fn, c_index, a, b)
    gflops = eff_flops / per_iter / 1e9

    # BASELINE metric 3 block-granularity throughput: block-matmuls/s is
    # the reference STATISTICS "marketing matmuls" counter per second
    # (one entry per contributing (C,A,B) block triple,
    # docs/guide/.../4-performance/1-insights.md), block-nnz/s the C
    # blocks produced per second. Host-side recompute of the symbolic
    # product (setup cost, not timed).
    from dbcsr_tpu.mm.plan import symbolic_product

    n_triples = symbolic_product(a.index, False, b.index, False).nnz_triples
    peak_share = {}
    if config == "block23" and not _TINY:
        # share of the published TF32 peak (the precision this run uses)
        peaks = device_peaks(jax.devices()[0].device_kind)
        peak_share["tf32_peak_share"] = round(
            gflops * 1e9 / peaks["tf32_flops"], 4
        )

    print(
        json.dumps(
            {
                "metric": metric,
                "value": round(gflops, 1),
                "unit": "GFLOP/s",
                "vs_baseline": None,
                **_device_record("default"),
                **peak_share,
                "block_matmuls_per_s": round(n_triples / per_iter),
                "block_nnz_per_s": round(len(c_index.col_idx) / per_iter),
            }
        )
    )


if __name__ == "__main__":
    main()
