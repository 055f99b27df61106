"""The multiply engine: C := alpha * op(A) * op(B) + beta * C.

Replacement for ``dbcsr_multiply_generic``
(``src/mm/dbcsr_mm.F:336-1023``) for the local (single-device) product.
The reference's five sub-layers (cannon/multrec/csr/sched/accdrv) collapse
into: host symbolic plan (``plan.py``) → tile-granular GEMM on the operand
TILE STORES (dense panel or Pallas tile stacks, ``kernels.py``) → tile-level
alignment into the result's store.

With the at-rest layout being the tile store (``block/store.py``), the
'N','N' steady-state path needs ZERO data movement before the product: the
store IS the operand panel. op='T'/'C' costs one tile permutation plus a
vectorized per-tile transpose. The result is produced directly in C's store
layout; beta-accumulation and pattern merging are tile-level gathers.

Engine selection (config ``mm_driver``, analog of the reference's
MM_DRIVER): "dense" scatters tiles into full padded panels and runs one
GEMM (the ``make_dense`` fast path, ``src/mm/dbcsr_mm.F:771-810``); "stack"
runs tile-level sparse stacks; "auto" picks by tile occupancy against
``dense_threshold``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace as _dc_replace
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..block.bcsr import BCSRMatrix, SYM_NONE
from ..block.index import BCSRIndex, build_index, merge_index
from ..block.store import store_layout
from ..block.tileops import (
    take_tiles,
    tile_align_map,
    transpose_store,
    valid_mask,
)
from ..core.config import get_config
from ..core.errors import DbcsrError, dbcsr_assert
from ..core.stats import get_stats
from ..core.timing import timed
from .kernels import crun_supported, tile_stack_matmul_crun, tile_stack_matmul_xla
from .plan import symbolic_product
from .tileplan import TileStackPlan, plan_tile_stacks_stores

__all__ = [
    "multiply",
    "build_multiply_executor",
    "build_distributed_executor",
    "select_route",
]

_PRECISIONS = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}


def _effective_trans(trans: str) -> Tuple[bool, bool]:
    trans = trans.upper()
    dbcsr_assert(trans in ("N", "T", "C"), f"bad transpose flag {trans!r}")
    return trans in ("T", "C"), trans == "C"


def _op_store(m: BCSRMatrix, trans: bool, conj: bool):
    """(tile store of op(M), row-major tile coords of op(M), op tile grid).
    'N' is free; 'T' is a tile permutation + vectorized transpose."""
    lay = m.layout
    if not trans:
        st = jnp.conj(m.data) if conj else m.data
        return st, lay.tile_coords, (lay.ntr, lay.ntc)
    st, coords = transpose_store(m.index, m.tile, m.data, conj=conj)
    return st, coords, (lay.ntc, lay.ntr)


@partial(jax.jit, static_argnames=("ntr", "ntc", "t"))
def _stores_to_panel(store, keys, *, ntr: int, ntc: int, t: int):
    """Tile-level scatter of a store into the full padded dense panel.

    When the store is tile-COMPLETE (every tile of the grid is occupied,
    keys are row-major so the store is already grid-ordered) the scatter
    disappears into a reshape+transpose that XLA fuses with the matmul."""
    if store.shape[0] == ntr * ntc:
        grid = store
    else:
        grid = jnp.zeros((ntr * ntc, t, t), dtype=store.dtype)
        if store.shape[0]:
            grid = grid.at[keys].set(store)
    return (
        grid.reshape(ntr, ntc, t, t).transpose(0, 2, 1, 3).reshape(ntr * t, ntc * t)
    )


@partial(jax.jit, static_argnames=("ntr", "ntc", "t"))
def _panel_to_tiles(panel, keys, *, ntr: int, ntc: int, t: int):
    """Tile-level gather of selected tiles out of a dense panel (identity
    reshape when the target tile set is complete)."""
    tiles = (
        panel.reshape(ntr, t, ntc, t).transpose(0, 2, 1, 3).reshape(ntr * ntc, t, t)
    )
    if keys.shape[0] == ntr * ntc:
        return tiles
    return jnp.take(tiles, keys, axis=0)


@jax.jit
def _combine(prod_aligned, old_aligned, alpha, beta):
    return alpha * prod_aligned + beta * old_aligned


@partial(jax.jit, static_argnames=("mt", "kt", "nt", "t", "prec"))
def _dense_tiles_einsum(a_store, b_store, *, mt, kt, nt, t, prec):
    """Dense product directly on tile-COMPLETE stores: a single einsum over
    4-D tile views — no reshape-transpose copies; XLA picks operand layouts
    and feeds the GEMM straight from the stores (fastest dense path)."""
    a4 = a_store.reshape(mt, kt, t, t)
    b4 = b_store.reshape(kt, nt, t, t)
    out4 = jnp.einsum(
        "mkat,kntb->mnab", a4, b4, precision=_PRECISIONS[prec],
        preferred_element_type=jnp.promote_types(jnp.float32, a_store.dtype),
    ).astype(a_store.dtype)
    return out4.reshape(mt * nt, t, t)


def _use_ozaki(dtype, cfg) -> bool:
    """True when f64 data should multiply via exact bf16 slice products
    (ops/f64_emu.py) instead of the native f64 dot. Only on request
    (``f64_method="ozaki"``): on the GPU a native f64 dot runs on the
    FP64 tensor cores, and on the CPU it is exact by construction."""
    return dtype == jnp.float64 and cfg.f64_method == "ozaki"


def _dense_tiles_ozaki(a_store, b_store, *, mt, kt, nt, t, n_slices):
    """f64 twin of ``_dense_tiles_einsum``: pack the tile-complete
    stores into 2-D panels and run the exact-slice product (K chunked
    tile-wide inside ozaki_matmul)."""
    from ..ops.f64_emu import ozaki_matmul

    a2 = a_store.reshape(mt, kt, t, t).transpose(0, 2, 1, 3).reshape(
        mt * t, kt * t
    )
    b2 = b_store.reshape(kt, nt, t, t).transpose(0, 2, 1, 3).reshape(
        kt * t, nt * t
    )
    out2 = ozaki_matmul(a2, b2, n_slices=n_slices, k_chunk=t)
    return out2.reshape(mt, t, nt, t).transpose(0, 2, 1, 3).reshape(
        mt * nt, t, t
    )


def _dense_tiles_product(a_st, b_st, *, mt, kt, nt, t, prec, cfg):
    """Dense tile-complete product, routed by dtype."""
    if _use_ozaki(a_st.dtype, cfg):
        return _dense_tiles_ozaki(
            a_st, b_st, mt=mt, kt=kt, nt=nt, t=t, n_slices=cfg.f64_slices
        )
    return _dense_tiles_einsum(a_st, b_st, mt=mt, kt=kt, nt=nt, t=t,
                               prec=prec)


def _panel_matmul(pa, pb, prec: str, cfg):
    """2-D panel product, routed by dtype."""
    if _use_ozaki(pa.dtype, cfg):
        from ..ops.f64_emu import ozaki_matmul

        return ozaki_matmul(pa, pb, n_slices=cfg.f64_slices)
    return jnp.matmul(pa, pb, precision=_PRECISIONS[prec])


def _tuned_driver(cfg, a_index, b_index):
    """Tuned per-class driver preference (only when the user left
    mm_driver at its default): the reference's parameter tables likewise
    select algorithm variants per workload class."""
    if cfg.provenance("mm_driver") != "D":
        return None
    from ..autotune import tuned_stack_params

    best = tuned_stack_params(a_index, b_index)
    if best:
        return best.get("mm_driver")
    return None


#: product routes: one dense GEMM, the band driver, or a tile-stack
#: product by the C-run kernel, XLA's gather/dot/segment-sum, or the
#: ozaki f64 slice scheme
ROUTES = ("dense", "band", "crun", "xla", "ozaki")
_DRIVERS = ("auto", "dense", "stack", "xla", "band")


@dataclass(frozen=True)
class ProductRoute:
    """The engine's kernel decision for one local product (``select_route``)."""

    kind: str
    tplan: Optional[TileStackPlan] = None  # every kind but "dense"
    bplan: Optional[object] = None  # BandPlan for "band"


def select_route(
    cfg, driver: str, dtype, tile: int, a_coords, b_coords, grid,
    a_index, b_index, *, tplan: Optional[TileStackPlan] = None,
    platform: Optional[str] = None,
) -> ProductRoute:
    """The one place that chooses how a local product runs, and the one
    platform test of the engine.

    ``mm_driver`` "dense" forces one dense GEMM; "band" forces the band
    driver; "stack" and "xla" force a tile-stack product; "auto" takes
    the dense path above ``dense_threshold`` tile occupancy, else the band
    driver when ``plan_band`` admits the pattern, else a stack product.
    A stack product runs the C-run kernel on the GPU for the dtypes,
    tiles and precisions it takes (``crun_supported``), the ozaki scheme for f64 on
    request, and XLA's form otherwise (and always under "xla").
    ``tplan`` passes in a cached tile plan; the choice is counted in the
    statistics (``MMStats.routes``)."""
    dbcsr_assert(driver in _DRIVERS, f"unknown mm_driver {driver!r}")
    route = _select_route(
        cfg, driver, dtype, tile, a_coords, b_coords, grid, a_index,
        b_index, tplan,
        platform if platform is not None else jax.default_backend(),
    )
    get_stats().record_route(route.kind)
    return route


def _select_route(cfg, driver, dtype, tile, a_coords, b_coords, grid,
                  a_index, b_index, tplan, platform) -> ProductRoute:
    mt, kt, nt = grid
    if driver == "dense":
        return ProductRoute("dense")
    if tplan is None:
        tplan = plan_tile_stacks_stores(a_coords, (mt, kt), b_coords, (kt, nt))
    if (
        driver == "auto"
        and len(tplan.stack) / max(mt * kt * nt, 1) >= cfg.dense_threshold
    ):
        return ProductRoute("dense")
    if driver in ("auto", "band"):
        from .band import plan_band

        force_band = driver == "band" or (
            driver == "auto" and _tuned_driver(cfg, a_index, b_index) == "band"
        )
        bplan = plan_band(
            a_coords, (mt, kt), b_coords, (kt, nt), tplan.c_tile_keys,
            tile=tile,
            n_stack=None if force_band else len(tplan.stack),
            max_products=cfg.band_max_products,
            # true-f32 products run several times slower than TF32 ones
            # while the stack products stay memory-bound, so the padded
            # band work gets a smaller budget (untuned for the H100)
            flop_factor=cfg.band_flop_factor
            * (1.0 if cfg.matmul_precision == "default" else 0.125),
        )
        if bplan is not None:
            return ProductRoute("band", tplan, bplan)
        if driver == "band":
            raise DbcsrError("pattern not band-suitable (see band.py)")
    if _use_ozaki(dtype, cfg):
        return ProductRoute("ozaki", tplan)
    if driver != "xla" and platform == "gpu" and crun_supported(
        dtype, tile, cfg.matmul_precision
    ):
        return ProductRoute("crun", tplan)
    return ProductRoute("xla", tplan)


def route_product(route: ProductRoute, a_st, b_st, c_keys, *, tile, grid,
                  a_coords, b_coords, prec: str, cfg) -> jax.Array:
    """Run ``route`` on the op-tile stores; returns the product tiles
    aligned to C's sorted tile keys ``c_keys`` (absent tiles zero).
    Traceable: the plan-once executors call it under jit."""
    mt, kt, nt = grid
    if route.kind == "dense":
        if len(a_coords) == mt * kt and len(b_coords) == kt * nt:
            # tile-complete operands: one einsum straight off the stores
            full = _dense_tiles_product(
                a_st, b_st, mt=mt, kt=kt, nt=nt, t=tile, prec=prec, cfg=cfg
            )
            if len(c_keys) == mt * nt:
                return full
            return jnp.take(full, jnp.asarray(c_keys), axis=0)
        if len(c_keys) == 0:
            return jnp.zeros((0, tile, tile), dtype=a_st.dtype)
        pa = _stores_to_panel(
            a_st,
            jnp.asarray(a_coords[:, 0].astype(np.int64) * kt + a_coords[:, 1]),
            ntr=mt, ntc=kt, t=tile,
        )
        pb = _stores_to_panel(
            b_st,
            jnp.asarray(b_coords[:, 0].astype(np.int64) * nt + b_coords[:, 1]),
            ntr=kt, ntc=nt, t=tile,
        )
        g = _panel_matmul(pa, pb, prec, cfg)
        return _panel_to_tiles(g, jnp.asarray(c_keys), ntr=mt, ntc=nt, t=tile)
    tp = route.tplan
    if len(tp.stack) == 0:
        return jnp.zeros((len(c_keys), tile, tile), dtype=a_st.dtype)
    if route.kind == "band":
        from .band import band_matmul

        prod = band_matmul(a_st, b_st, route.bplan, tile=tile, precision=prec)
    elif route.kind == "crun":
        prod = tile_stack_matmul_crun(
            a_st, b_st, tp.stack, n_c_tiles=tp.n_c_tiles, precision=prec
        )
    elif route.kind == "ozaki":
        from ..ops.f64_emu import tile_stack_matmul_ozaki

        prod = tile_stack_matmul_ozaki(
            a_st, b_st, jnp.asarray(tp.stack), n_c_tiles=tp.n_c_tiles,
            n_slices=cfg.f64_slices,
        )
    else:
        prod = tile_stack_matmul_xla(
            a_st, b_st, jnp.asarray(tp.stack), n_c_tiles=tp.n_c_tiles,
            precision=prec,
        )
    # align product tiles (sorted by product key) to C's tile set
    return take_tiles(prod, tile_align_map(c_keys, tp.c_tile_keys), tile)


def route_hw_flops(route: ProductRoute, grid, tile: int) -> float:
    """Tile-granular flops the route issues."""
    if route.kind == "dense":
        mt, kt, nt = grid
        return 2.0 * float(mt) * kt * nt * tile**3
    if route.kind == "band":
        return route.bplan.hw_flops
    return 2.0 * len(route.tplan.stack) * tile**3


def _align_old_c(
    c: Optional[BCSRMatrix], c_index: BCSRIndex, tile: int
) -> Optional[jax.Array]:
    """Old C's store gathered into the new C tile layout (tile-level)."""
    if c is None or c.nblks == 0:
        return None
    new_lay = store_layout(c_index, tile)
    amap = tile_align_map(new_lay.tile_keys(), c.layout.tile_keys())
    return take_tiles(c.data, amap, tile)


def multiply(
    transa: str,
    transb: str,
    alpha,
    a: BCSRMatrix,
    b: BCSRMatrix,
    beta=0.0,
    c: Optional[BCSRMatrix] = None,
    *,
    filter_eps: Optional[float] = None,
    retain_sparsity: bool = False,
    return_flops: bool = False,
    dist=None,
    k_dist: Optional[np.ndarray] = None,
    limits: Optional[dict] = None,
):
    """Sparse multiply with the reference's full semantics
    (``dbcsr_multiply``, ``src/dbcsr_api.F:1411``): transposes/conjugation,
    alpha/beta scaling, product-block discovery, epsilon filtering,
    retain-sparsity mode, sub-matrix limits.

    With a ``dist`` (explicit, or carried by ``c``/``a``) the product runs
    distributed over the 2-D device mesh via Cannon ring shifts
    (``cannon.py``); otherwise on the local engine.

    Iterative filtered callers (linear-scaling SCF: same patterns, new
    data every step): use ``build_filtered_executor`` (mm/filtered.py)
    instead of per-call ``filter_eps`` — the device-resident pipeline
    measured 2.86 ms/call where this one-shot path pays ~94 ms
    [CHIP 2026-08-19].
    """
    from ..ops.transform import desymmetrize

    if (
        a.is_complex_emulated
        or b.is_complex_emulated
        or (c is not None and c.is_complex_emulated)
    ):
        from ..ops.complex_emu import emu_multiply

        return emu_multiply(
            transa, transb, alpha, a, b, beta, c,
            filter_eps=filter_eps, retain_sparsity=retain_sparsity,
            return_flops=return_flops, dist=dist, k_dist=k_dist,
            limits=limits,
        )

    cfg = get_config()
    ta, ca = _effective_trans(transa)
    tb, cb = _effective_trans(transb)

    if limits is not None:
        return _multiply_limited(
            transa, transb, alpha, a, b, beta, c,
            filter_eps=filter_eps, return_flops=return_flops,
            dist=dist, limits=limits,
        )

    with timed("multiply"):
        a = desymmetrize(a)
        b = desymmetrize(b)
        dbcsr_assert(a.tile == b.tile, "operand tile sizes differ")

        m_sizes = a.index.col_block_sizes if ta else a.index.row_block_sizes
        k_sizes_a = a.index.row_block_sizes if ta else a.index.col_block_sizes
        k_sizes_b = b.index.col_block_sizes if tb else b.index.row_block_sizes
        n_sizes = b.index.row_block_sizes if tb else b.index.col_block_sizes
        dbcsr_assert(
            np.array_equal(k_sizes_a, k_sizes_b),
            "inner block dimensions do not match",
        )
        if c is not None:
            dbcsr_assert(
                np.array_equal(c.index.row_block_sizes, m_sizes)
                and np.array_equal(c.index.col_block_sizes, n_sizes),
                "C block structure does not match the product",
            )
            dbcsr_assert(c.tile == a.tile, "C tile size differs from operands")
        c_sym = c.sym if c is not None else SYM_NONE
        if c_sym != SYM_NONE:
            # symmetric product matrix: compute in full storage, fold back
            # (reference: canonical symmetric index, src/mm/dbcsr_mm.F:714)
            from ..ops.transform import fold_symmetric

            c_full = desymmetrize(c)
            out = multiply(
                transa, transb, alpha, a, b, beta, c_full,
                filter_eps=filter_eps, retain_sparsity=retain_sparsity,
                return_flops=return_flops, dist=dist, k_dist=k_dist,
            )
            if return_flops:
                out, fl = out
                return fold_symmetric(out, c_sym), fl
            return fold_symmetric(out, c_sym)

        # ---- plan -------------------------------------------------------
        with timed("multiply/plan"):
            from .plancache import get_plan_cache

            pcache = get_plan_cache()
            cache_key = None
            cached = None
            if filter_eps is None:  # filtered patterns depend on data norms
                cache_key = pcache.key(a.index, ta, b.index, tb)
                cached = pcache.get(cache_key)
            if cached is not None:
                symb, prod_index = cached
            else:
                a_nsq = b_nsq = None
                if filter_eps is not None:
                    from ..ops.norms import block_norms_sq

                    a_nsq = np.asarray(block_norms_sq(a))
                    b_nsq = np.asarray(block_norms_sq(b))
                symb = symbolic_product(
                    a.index, ta, b.index, tb,
                    a_norms_sq=a_nsq, b_norms_sq=b_nsq,
                    filter_eps=filter_eps, per_row_eps=cfg.per_row_eps,
                )
                prod_index = None
            if retain_sparsity:
                dbcsr_assert(c is not None, "retain_sparsity requires c")
                c_index = c.index
            else:
                if prod_index is None:
                    if cache_key is None:
                        # filtered path: the SYMBOLIC plan is data-
                        # dependent (norms), but once the surviving
                        # pattern is known the built index is pure
                        # content — intern it so repeat calls over a
                        # converged pattern (late SCF) reuse one index
                        # object and every per-index derived cache
                        # (store layout, tile_block_info, valid_mask)
                        from .plancache import array_fingerprint

                        fkey = pcache.key(
                            a.index, ta, b.index, tb,
                            extra=(
                                "filtered_prod",
                                array_fingerprint(symb.rows, symb.cols),
                            ),
                        )
                        fc = pcache.get(fkey)
                        if fc is not None:
                            prod_index = fc[0]
                        else:
                            prod_index, _ = build_index(
                                symb.rows, symb.cols, m_sizes, n_sizes
                            )
                            pcache.put(fkey, (prod_index,))
                    else:
                        prod_index, _ = build_index(
                            symb.rows, symb.cols, m_sizes, n_sizes
                        )
                        pcache.put(cache_key, (symb, prod_index))
                if c is not None and c.nblks:
                    c_index, _, _ = merge_index(c.index, prod_index)
                else:
                    c_index = prod_index

        # ---- execute ----------------------------------------------------
        eff_dist = dist
        if eff_dist is None and c is not None:
            eff_dist = c.dist
        if eff_dist is None:
            eff_dist = a.dist
        if eff_dist is not None:
            grid = eff_dist.grid
            algo = cfg.mm_dist_algo
            if algo == "auto":
                algo = "cannon" if grid.nprow == grid.npcol else "summa"
            if algo == "summa":
                from .summa import execute_summa as _exec_dist
            else:
                dbcsr_assert(
                    grid.nprow == grid.npcol,
                    "Cannon requires a square grid; use mm_dist_algo='summa'",
                )
                from .cannon import execute_cannon as _exec_dist

            with timed(f"multiply/{algo}"):
                out_data = _exec_dist(
                    a, ta, ca, b, tb, cb, c, c_index,
                    alpha, beta, eff_dist, k_dist, cfg,
                    mask_result=(filter_eps is not None or retain_sparsity),
                )
        else:
            with timed("multiply/exec"):
                out_data = _execute_local(
                    a, ta, ca, b, tb, cb, c, c_index, alpha, beta, cfg,
                    mask_result=(filter_eps is not None or retain_sparsity),
                )

        result = BCSRMatrix(
            name=(c.name if c is not None else "product"),
            index=c_index,
            data=out_data,
            sym=SYM_NONE,
            dist=(c.dist if c is not None else eff_dist),
        )

        # ---- final norm filter (multrec_filtering analog) ---------------
        if filter_eps is not None and not retain_sparsity:
            from ..ops.arithmetic import filter_blocks

            result = filter_blocks(result, filter_eps)

        stats = get_stats()
        stats.num_multiplications += 1
        stats.total_flops += symb.eff_flops
        # peak device memory per multiply (the reference tracks max memory
        # at dbcsr_mm_cannon.F:1723-1725)
        from ..core.machine import device_memory_stats

        dm = device_memory_stats()
        if dm and "peak_bytes_in_use" in dm:
            stats.max_memory_bytes = max(
                stats.max_memory_bytes, int(dm["peak_bytes_in_use"])
            )
        if cfg.collect_mnk_stats:
            # per-(m,n,k) statistics depend only on the operand patterns
            # and the surviving C pattern — iterative callers (SCF steps
            # over a converged pattern) repeat them exactly, and the
            # O(S) class-bucketing pass was ~40% of the filtered bench's
            # per-call host time. Cache alongside the symbolic plans.
            from .plancache import array_fingerprint, get_plan_cache

            pcache = get_plan_cache()
            skey = pcache.key(
                a.index, ta, b.index, tb,
                extra=("mnk_stats", array_fingerprint(symb.rows, symb.cols)),
            )
            scached = pcache.get(skey)
            if scached is not None:
                mnk = scached[0]
            else:
                from .plan import mnk_statistics

                mnk = mnk_statistics(
                    a.index, ta, b.index, tb, symb.rows, symb.cols
                )
                pcache.put(skey, (mnk,))
            for (m_, n_, k_), (cnt, fl) in mnk.items():
                prev_cnt, prev_fl = stats.by_mnk.get((m_, n_, k_), (0, 0.0))
                stats.by_mnk[(m_, n_, k_)] = (prev_cnt + cnt, prev_fl + fl)

    if return_flops:
        return result, symb.eff_flops
    return result


def _execute_local(
    a: BCSRMatrix,
    ta: bool,
    ca: bool,
    b: BCSRMatrix,
    tb: bool,
    cb: bool,
    c: Optional[BCSRMatrix],
    c_index: BCSRIndex,
    alpha,
    beta,
    cfg,
    *,
    mask_result: bool,
) -> jax.Array:
    tile = a.tile
    a_st, a_coords, (mt, kt) = _op_store(a, ta, ca)
    b_st, b_coords, (kt2, nt) = _op_store(b, tb, cb)
    dbcsr_assert(kt == kt2, "tile grid K mismatch")

    c_lay = store_layout(c_index, tile)
    c_keys = c_lay.tile_keys()

    driver = cfg.mm_driver
    tplan = None
    if driver != "dense":
        with timed("multiply/tileplan"):
            # the tile-triple plan depends only on the operand tile
            # patterns (coords derive from index + trans + tile size):
            # cache it so iterative one-shot callers — including
            # FILTERED multiplies, whose C pattern varies but whose
            # operand plan does not — skip the enumerate+sort pass
            from .plancache import get_plan_cache

            _pc = get_plan_cache()
            _tkey = _pc.key(
                a.index, ta, b.index, tb, extra=("tileplan", tile)
            )
            _tc = _pc.get(_tkey)
            if _tc is not None:
                tplan = _tc[0]
            else:
                tplan = plan_tile_stacks_stores(
                    a_coords, (mt, kt), b_coords, (kt, nt)
                )
                _pc.put(_tkey, (tplan,))

    grid = (mt, kt, nt)
    route = select_route(
        cfg, driver, a.dtype, tile, a_coords, b_coords, grid, a.index,
        b.index, tplan=tplan,
    )
    with timed(f"multiply/{route.kind}"):
        prod = route_product(
            route, a_st, b_st, c_keys, tile=tile, grid=grid,
            a_coords=a_coords, b_coords=b_coords,
            prec=cfg.matmul_precision, cfg=cfg,
        )
    get_stats().hardware_flops += route_hw_flops(route, grid, tile)

    if mask_result and len(c_keys):
        prod = prod * valid_mask(c_index, tile).astype(prod.dtype)

    old = _align_old_c(c, c_index, tile)
    alpha_ = jnp.asarray(alpha, dtype=a.dtype)
    beta_ = jnp.asarray(beta, dtype=a.dtype)
    if old is None:
        return (alpha_ * prod).astype(a.dtype)
    return _combine(prod.astype(a.dtype), old, alpha_, beta_)


def _multiply_limited(
    transa: str,
    transb: str,
    alpha,
    a: BCSRMatrix,
    b: BCSRMatrix,
    beta,
    c: Optional[BCSRMatrix],
    *,
    filter_eps,
    return_flops: bool,
    dist,
    limits: dict,
):
    """Sub-matrix multiplication window (the reference's
    ``first_row/last_row/first_column/last_column/first_k/last_k``
    parameters, ``src/mm/dbcsr_mm.F:630-709``): the product is computed only
    over the given half-open BLOCK-index ranges ``limits={"rows": (r0, r1),
    "cols": ..., "k": ...}``, while ``beta * C`` applies to the whole C.

    Runs as extract → multiply (compacted) → re-expand — this library's form
    of the reference's crop-to-limits in ``make_images``
    (``src/mm/dbcsr_mm_cannon.F:146``)."""
    from ..ops.arithmetic import add
    from ..ops.transform import desymmetrize as desym
    from ..tas.matrix import extract_block_subset

    ta, _ = _effective_trans(transa)
    tb, _ = _effective_trans(transb)
    a = desym(a)
    b = desym(b)
    m_sizes = a.index.col_block_sizes if ta else a.index.row_block_sizes
    k_sizes = a.index.row_block_sizes if ta else a.index.col_block_sizes
    n_sizes = b.index.row_block_sizes if tb else b.index.col_block_sizes

    def _range(key, n):
        lo, hi = limits.get(key, (0, n))
        dbcsr_assert(0 <= lo <= hi <= n, f"bad {key} limits ({lo},{hi})")
        return np.arange(lo, hi, dtype=np.int64)

    rows_sel = _range("rows", len(m_sizes))
    cols_sel = _range("cols", len(n_sizes))
    k_sel = _range("k", len(k_sizes))

    a_sub = (
        extract_block_subset(a, row_blocks=k_sel, col_blocks=rows_sel)
        if ta
        else extract_block_subset(a, row_blocks=rows_sel, col_blocks=k_sel)
    )
    b_sub = (
        extract_block_subset(b, row_blocks=cols_sel, col_blocks=k_sel)
        if tb
        else extract_block_subset(b, row_blocks=k_sel, col_blocks=cols_sel)
    )
    window, fl = multiply(
        transa, transb, alpha, a_sub, b_sub,
        filter_eps=filter_eps, dist=dist, return_flops=True,
    )
    # re-expand into the full C block space (selections are ascending ranges,
    # so canonical block order — and the flat layout — are preserved)
    w_idx = window.index
    full_index, order = build_index(
        rows_sel[w_idx.blk_rows].astype(np.int64),
        cols_sel[w_idx.col_idx].astype(np.int64),
        m_sizes,
        n_sizes,
    )
    dbcsr_assert(
        np.array_equal(order, np.arange(len(order))),
        "window expansion must preserve block order",
    )
    expanded = BCSRMatrix.from_flat(
        full_index, window.flat_host(), name="product", dist=dist,
        tile=window.tile,
    )
    if c is not None:
        result = add(1.0, expanded, beta, c)
        result = _dc_replace(result, name=c.name)
    else:
        result = expanded
    if return_flops:
        return result, fl
    return result


def build_distributed_executor(
    transa: str,
    transb: str,
    a: BCSRMatrix,
    b: BCSRMatrix,
    dist,
    *,
    k_dist: Optional[np.ndarray] = None,
    algo: Optional[str] = None,
    sharded: bool = False,
):
    """Plan-once distributed executor: ``fn(a_store, b_store) -> c_store``
    running the tiled Cannon (square grids) or SUMMA schedule with all host
    planning done up front — the distributed steady-state form for
    weak-scaling measurement (BASELINE metric #2).

    With ``sharded=True`` (all transpose combinations supported, see
    ``tests/test_sharded.py``) the executor consumes and produces the
    SHARDED at-rest form (``dist/sharded.py``): inputs are
    ``[ndev, n_max, T, T]`` owner-partitioned arrays, the output is C's
    sharded store (its per-device tile order IS the plan's C ordering), and
    the panel re-distribution happens inside jit as mesh collectives — the
    make_images alltoall of the reference. Convert with
    ``shard_store``/``unshard_store``."""
    from ..ops.transform import desymmetrize

    cfg = get_config()
    ta, ca = _effective_trans(transa)
    tb, cb = _effective_trans(transb)
    a = desymmetrize(a)
    b = desymmetrize(b)
    tile = a.tile
    grid = dist.grid
    if algo is None:
        algo = cfg.mm_dist_algo
    if algo == "auto":
        algo = "cannon" if grid.nprow == grid.npcol else "summa"

    m_sizes = a.index.col_block_sizes if ta else a.index.row_block_sizes
    k_sizes = a.index.row_block_sizes if ta else a.index.col_block_sizes
    n_sizes = b.index.row_block_sizes if tb else b.index.col_block_sizes
    symb = symbolic_product(a.index, ta, b.index, tb)
    c_index, _ = build_index(symb.rows, symb.cols, m_sizes, n_sizes)

    if k_dist is None:
        from ..dist.distribution import tile_dist_vector

        k_dist = tile_dist_vector(
            k_sizes, grid.nprow if algo == "cannon" else max(grid.nprow, grid.npcol),
            tile,
        )

    # op-store permutations (reused per call)
    def op_closure(m, trans, conj):
        if not trans:
            return (lambda d: jnp.conj(d) if conj else d), m.layout.tile_coords, None
        lay = m.layout
        keys_t = lay.tile_coords[:, 1].astype(np.int64) * lay.ntr + lay.tile_coords[:, 0]
        perm_np = np.argsort(keys_t)
        perm = jnp.asarray(perm_np.astype(np.int32))
        coords = np.stack(
            [lay.tile_coords[perm_np, 1], lay.tile_coords[perm_np, 0]], axis=1
        ).astype(np.int32)

        def op(d):
            st = jnp.swapaxes(jnp.take(d, perm, axis=0), 1, 2)
            return jnp.conj(st) if conj else st

        return op, coords, perm_np

    a_op, a_coords, a_perm_np = op_closure(a, ta, ca)
    b_op, b_coords, b_perm_np = op_closure(b, tb, cb)
    c_lay = store_layout(c_index, tile)

    from ..dist.distribution import dist_tile_bins

    rowb = dist_tile_bins(dist.row_dist, m_sizes, tile, majority=True)
    colb = dist_tile_bins(dist.col_dist, n_sizes, tile, majority=True)
    kb = dist_tile_bins(k_dist, k_sizes, tile, majority=True)
    p, q = grid.nprow, grid.npcol
    prec = cfg.matmul_precision

    shard_in = shard_out = None
    if sharded:
        from jax.sharding import NamedSharding, PartitionSpec as _P

        from ..dist.grid import AXIS_COL as _AC, AXIS_ROW as _AR
        from ..dist.sharded import shard_layout_from_bins

        # each operand shards along its OWN stored dims: the per-tile bin
        # of a logical dim (m->rowb, n->colb, k->kb) folded onto the grid
        a_rbins = (kb % p) if ta else rowb
        a_cbins = (rowb % q) if ta else (kb % q)
        b_rbins = (colb % p) if tb else (kb % p)
        b_cbins = (kb % q) if tb else (colb % q)
        sl_a = shard_layout_from_bins(a.index, tile, a_rbins, a_cbins, p, q)
        sl_b = shard_layout_from_bins(b.index, tile, b_rbins, b_cbins, p, q)
        sl_c = shard_layout_from_bins(c_index, tile, rowb, colb, p, q)

        def remap(pack, sl, perm_np):
            # pack indexes the OP store; compose with the transpose perm to
            # reach original store slots, then the shard positions
            idx = pack.astype(np.int64)
            if perm_np is not None:
                idx = np.where(
                    idx >= 0, perm_np[np.maximum(idx, 0)], -1
                )
            out = np.where(
                idx >= 0,
                sl.pos_of_slot[np.minimum(idx, len(sl.pos_of_slot) - 1)],
                np.int64(np.iinfo(np.int32).max),
            )
            return out.astype(np.int64)

        shard_in = (sl_a, sl_b, remap)
        if grid.nlayer > 1:
            from ..dist.grid import AXIS_LAYER as _AL

            panel_sharding = NamedSharding(grid.mesh, _P(_AR, _AC, _AL))
        else:
            panel_sharding = NamedSharding(grid.mesh, _P(_AR, _AC))
        out_sharding = NamedSharding(grid.mesh, _P((_AR, _AC)))
        shard_out = (sl_c, panel_sharding, out_sharding)

    if algo == "cannon":
        dbcsr_assert(p == q, "Cannon requires a square grid")
        from .cannon import _cannon_exec, plan_cannon_tiled

        plan = plan_cannon_tiled(
            a_coords, b_coords, c_lay, rowb, colb, kb, p, grid.nlayer
        )
        stacks_j = jnp.asarray(plan.stacks)

        if sharded:
            sl_a, sl_b, remap = shard_in
            sl_c, panel_sh, out_sh = shard_out
            dbcsr_assert(plan.n_c == sl_c.n_max, "C shard layout mismatch")
            a_pos = jnp.asarray(remap(plan.a_pack, sl_a, a_perm_np))
            b_pos = jnp.asarray(remap(plan.b_pack, sl_b, b_perm_np))

            def op_tiles(x, trans, conj):
                if trans:
                    x = jnp.swapaxes(x, -2, -1)
                return jnp.conj(x) if conj else x

            def fn(a_sh, b_sh):
                af = a_sh.reshape(sl_a.ndev * sl_a.n_max, tile, tile)
                bf = b_sh.reshape(sl_b.ndev * sl_b.n_max, tile, tile)
                a_store = op_tiles(jnp.take(
                    af, a_pos, axis=0, mode="fill", fill_value=0
                ), ta, ca).reshape(p, p, grid.nlayer, plan.n_a, tile, tile)
                b_store = op_tiles(jnp.take(
                    bf, b_pos, axis=0, mode="fill", fill_value=0
                ), tb, cb).reshape(p, p, grid.nlayer, plan.n_b, tile, tile)
                a_store = jax.lax.with_sharding_constraint(a_store, panel_sh)
                b_store = jax.lax.with_sharding_constraint(b_store, panel_sh)
                c_tiles = _cannon_exec(
                    a_store, b_store, stacks_j,
                    p=p, layers=grid.nlayer, n_a=plan.n_a, n_b=plan.n_b,
                    n_c=plan.n_c, tile=tile, s_max=plan.s_max, prec=prec,
                    mesh=grid.mesh,
                )
                out = c_tiles.reshape(sl_c.ndev, sl_c.n_max, tile, tile)
                return jax.lax.with_sharding_constraint(out, out_sh)

            fn.shard_a, fn.shard_b, fn.shard_c = sl_a, sl_b, sl_c
            return fn, c_index, symb.eff_flops

        def fn(a_data, b_data):
            a_store = take_tiles(a_op(a_data), plan.a_pack, tile).reshape(
                p, p, grid.nlayer, plan.n_a, tile, tile
            )
            b_store = take_tiles(b_op(b_data), plan.b_pack, tile).reshape(
                p, p, grid.nlayer, plan.n_b, tile, tile
            )
            c_tiles = _cannon_exec(
                a_store, b_store, stacks_j,
                p=p, layers=grid.nlayer, n_a=plan.n_a, n_b=plan.n_b,
                n_c=plan.n_c, tile=tile, s_max=plan.s_max, prec=prec,
                mesh=grid.mesh,
            )
            return take_tiles(
                c_tiles.reshape(p * p * plan.n_c, tile, tile),
                plan.c_unpack, tile,
            )
    else:
        from .summa import _summa_exec, plan_summa

        plan = plan_summa(
            a_coords, b_coords, c_lay, rowb, colb, kb % q, kb % p, p, q,
            grid.nlayer,
        )
        stacks_j = jnp.asarray(plan.stacks)
        lshape = (p, q, grid.nlayer) if grid.nlayer > 1 else (p, q)

        if sharded:
            from .summa import _summa_exec as _sx

            sl_a, sl_b, remap = shard_in
            sl_c, panel_sh, out_sh = shard_out
            dbcsr_assert(plan.n_c == sl_c.n_max, "C shard layout mismatch")
            a_pos = jnp.asarray(remap(plan.a_pack, sl_a, a_perm_np))
            b_pos = jnp.asarray(remap(plan.b_pack, sl_b, b_perm_np))

            def op_tiles(x, trans, conj):
                if trans:
                    x = jnp.swapaxes(x, -2, -1)
                return jnp.conj(x) if conj else x

            def fn(a_sh, b_sh):
                af = a_sh.reshape(sl_a.ndev * sl_a.n_max, tile, tile)
                bf = b_sh.reshape(sl_b.ndev * sl_b.n_max, tile, tile)
                a_store = op_tiles(jnp.take(
                    af, a_pos, axis=0, mode="fill", fill_value=0
                ), ta, ca).reshape(*lshape, plan.n_a, tile, tile)
                b_store = op_tiles(jnp.take(
                    bf, b_pos, axis=0, mode="fill", fill_value=0
                ), tb, cb).reshape(*lshape, plan.n_b, tile, tile)
                a_store = jax.lax.with_sharding_constraint(a_store, panel_sh)
                b_store = jax.lax.with_sharding_constraint(b_store, panel_sh)
                c_tiles = _sx(
                    a_store, b_store, stacks_j,
                    p=p, q=q, n_a=plan.n_a, n_b=plan.n_b, n_c=plan.n_c,
                    tile=tile, s_max=plan.s_max, prec=prec, mesh=grid.mesh,
                    layers=grid.nlayer,
                )
                out = c_tiles.reshape(sl_c.ndev, sl_c.n_max, tile, tile)
                return jax.lax.with_sharding_constraint(out, out_sh)

            fn.shard_a, fn.shard_b, fn.shard_c = sl_a, sl_b, sl_c
            return fn, c_index, symb.eff_flops

        def fn(a_data, b_data):
            a_store = take_tiles(a_op(a_data), plan.a_pack, tile).reshape(
                *lshape, plan.n_a, tile, tile
            )
            b_store = take_tiles(b_op(b_data), plan.b_pack, tile).reshape(
                *lshape, plan.n_b, tile, tile
            )
            c_tiles = _summa_exec(
                a_store, b_store, stacks_j,
                p=p, q=q, n_a=plan.n_a, n_b=plan.n_b, n_c=plan.n_c,
                tile=tile, s_max=plan.s_max, prec=prec, mesh=grid.mesh,
                layers=grid.nlayer,
            )
            return take_tiles(
                c_tiles.reshape(p * q * plan.n_c, tile, tile),
                plan.c_unpack, tile,
            )

    return fn, c_index, symb.eff_flops


def build_multiply_executor(
    transa: str,
    transb: str,
    a: BCSRMatrix,
    b: BCSRMatrix,
    *,
    driver: Optional[str] = None,
):
    """Plan once, execute many: returns ``(fn, c_index, eff_flops)`` where
    ``fn(a_store, b_store) -> c_store`` is a pure jittable function computing
    op(A)·op(B) for NEW DATA with the SAME sparsity patterns.

    The analog of the reference's batched-multiply state machine
    (``dbcsr_tas_batched_mm_*``): iterative algorithms (SCF, matrix
    iterations) repeat products over fixed patterns — the symbolic plan and
    all tile maps are reused, so steady-state cost is pure device time
    (for 'N','N' there is NO packing at all: the at-rest store is the
    operand panel and the output is C's store).

    The returned ``fn`` is jitted: an EAGER caller (the TAS batched
    state machine, one-shot loops) then pays ONE dispatch per call
    instead of one per traced op. Callers that trace ``fn`` inside their
    own jit inline it as before. The product's route is chosen once, at
    build time (:func:`select_route`).
    """
    from ..ops.transform import desymmetrize

    cfg = get_config()
    ta, ca = _effective_trans(transa)
    tb, cb = _effective_trans(transb)
    a = desymmetrize(a)
    b = desymmetrize(b)
    tile = a.tile
    m_sizes = a.index.col_block_sizes if ta else a.index.row_block_sizes
    n_sizes = b.index.row_block_sizes if tb else b.index.col_block_sizes
    symb = symbolic_product(a.index, ta, b.index, tb)
    c_index, _ = build_index(symb.rows, symb.cols, m_sizes, n_sizes)
    c_lay = store_layout(c_index, tile)
    c_keys = c_lay.tile_keys()

    # host-side op-pattern metadata (reused across calls)
    a_lay, b_lay = a.layout, b.layout
    if ta:
        _, a_coords = transpose_store(a.index, tile, a.data)
        a_perm_keys = a.layout.tile_coords[:, 1].astype(np.int64) * a_lay.ntr + a.layout.tile_coords[:, 0]
        a_perm = jnp.asarray(np.argsort(a_perm_keys).astype(np.int32))
        mt, kt = a_lay.ntc, a_lay.ntr
    else:
        a_coords, a_perm = a_lay.tile_coords, None
        mt, kt = a_lay.ntr, a_lay.ntc
    if tb:
        _, b_coords = transpose_store(b.index, tile, b.data)
        b_perm_keys = b.layout.tile_coords[:, 1].astype(np.int64) * b_lay.ntr + b.layout.tile_coords[:, 0]
        b_perm = jnp.asarray(np.argsort(b_perm_keys).astype(np.int32))
        kt2, nt = b_lay.ntc, b_lay.ntr
    else:
        b_coords, b_perm = b_lay.tile_coords, None
        kt2, nt = b_lay.ntr, b_lay.ntc
    dbcsr_assert(kt == kt2, "tile grid K mismatch")

    drv = driver or cfg.mm_driver
    grid = (mt, kt, nt)
    route = select_route(
        cfg, drv, a.dtype, tile, a_coords, b_coords, grid, a.index, b.index
    )
    prec = cfg.matmul_precision

    def op_store(data, perm, conj):
        st = data
        if perm is not None:
            st = jnp.swapaxes(jnp.take(st, perm, axis=0), 1, 2)
        return jnp.conj(st) if conj else st

    def fn(a_data, b_data):
        return route_product(
            route, op_store(a_data, a_perm, ca), op_store(b_data, b_perm, cb),
            c_keys, tile=tile, grid=grid, a_coords=a_coords,
            b_coords=b_coords, prec=prec, cfg=cfg,
        )

    return jax.jit(fn), c_index, symb.eff_flops
