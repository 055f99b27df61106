"""SUMMA distributed multiply over arbitrary (non-square) 2-D meshes.

The reference offers two distributed algorithms: Cannon point-to-point
shifts (``dbcsr_mm_cannon.F``) and the one-sided 2.5D driver
(``dbcsr_mm_3d.F``), with "image decimation" to run Cannon on non-square
grids (``dbcsr_mm_dist_operations.F:56-212``). The second
algorithm is SUMMA: device (i, j) owns the C tiles with row-bin i / col-bin
j and consumes A's row-panel i (k-sharded along the 'pc' axis) and B's
col-panel j (k-sharded along 'pr'); each k-step broadcasts one k-slice —
here ``lax.all_gather`` over one mesh axis, which XLA pipelines over the
interconnect.
SUMMA has no grid-shape constraint, so it is the dispatch choice whenever
nprow != npcol (the reference reaches the same generality via virtual-image
decimation of Cannon).

Work partitioning is tile-granular like the tiled Cannon path (block
distributions honored as their nearest tile-aligned form).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..block.bcsr import BCSRMatrix
from ..block.index import BCSRIndex
from ..block.store import store_layout
from ..block.tileops import take_tiles, valid_mask
from ..core.stats import get_stats
from ..core.timing import timed
from ..dist.distribution import Distribution, dist_tile_bins
from ..dist.grid import AXIS_COL, AXIS_ROW
from .tileplan import enumerate_tile_triples

__all__ = ["execute_summa", "pad_summa_plan"]

_PRECISIONS = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}


@dataclass
class SummaPlan:
    p: int  # nprow
    q: int  # npcol
    n_a: int  # A panel capacity (tiles) per device
    n_b: int
    n_c: int
    s_max: int
    a_pack: np.ndarray  # int32 [P*Q*L*n_a] op-store slot (-1 pad)
    b_pack: np.ndarray
    stacks: np.ndarray  # int32 [P, Q(, L), s_max, 3] (c, a_local, b_local)
    c_unpack: np.ndarray  # int32 [c n_tiles] -> [P*Q*n_c] position
    layers: int = 1  # 2.5D C-reduction layers (L); legacy shapes when 1


def plan_summa(
    a_coords: np.ndarray,
    b_coords: np.ndarray,
    c_layout,
    rowb: np.ndarray,  # m tile-row -> prow
    colb: np.ndarray,  # n tile-col -> pcol
    kb_a: np.ndarray,  # k tile -> pcol bin (A's k sharding)
    kb_b: np.ndarray,  # k tile -> prow bin (B's k sharding)
    p: int,
    q: int,
    layers: int = 1,
) -> SummaPlan:
    """Tile-granular SUMMA schedule.

    A tile (tr, tc) lives on device (rowb[tr], kb_a[tc]); B tile (tr, tc)
    on (kb_b[tr], colb[tc]). After the all_gathers every device holds A's
    full row-panel and B's full col-panel, so the local stacks reference
    positions in the GATHERED panels: A slot = owner_col * n_a + local slot.
    (Plans sharing one shard_map pad to common capacities with
    :func:`pad_summa_plan`.)

    Fully vectorized single pass (no Python loop over tiles, panels or
    grid cells): panels, pack maps, per-device C sets and per-device
    stacks all come from one global triple enumeration + numpy grouping.

    With ``layers > 1`` each k tile additionally carries a 2.5D layer
    (round-robin within its (kq, kp) bin pair — the tile-granular
    ``make_layers_3D_C_reduction``, ``src/mm/dbcsr_mm_3d.F:1038``): panels
    and stacks grow a layer axis and per-layer C partials are psum'd over
    the layer mesh axis by the executor.
    """
    from .cannon import _tile_layer_split

    mt, ktl, ntc = int(len(rowb)), int(len(kb_a)), int(len(colb))
    L = int(layers)
    klay = _tile_layer_split(kb_a * p + kb_b, L)

    # --- owner panels: panel id + slot within panel per tile -------------
    def panelize(coords, rk, ck, ncpan):
        pid = (
            rk[coords[:, 0]].astype(np.int64) * ncpan
            + ck[coords[:, 1]].astype(np.int64)
        )
        order = np.argsort(pid, kind="stable")
        counts = np.bincount(pid, minlength=1)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.empty(len(pid), dtype=np.int64)
        slot[order] = np.arange(len(pid), dtype=np.int64) - starts[pid[order]]
        return pid, slot, counts

    # A panel key (i, kq, l); B panel key (kp, j, l)
    a_pid, a_slot, a_counts = panelize(
        a_coords, rowb, kb_a * L + klay, q * L
    )
    b_pid, b_slot, b_counts = panelize(
        b_coords, kb_b * L + klay, colb, q
    )
    n_a = max(int(a_counts.max()) if a_counts.size else 0, 1)
    n_b = max(int(b_counts.max()) if b_counts.size else 0, 1)

    # pack index layouts: A -> [i, kq, l, slot], B -> [kp, j, l, slot]
    a_i, a_kql = a_pid // (q * L), a_pid % (q * L)
    a_kq, a_l = a_kql // L, a_kql % L
    a_pack = np.full(p * q * L * n_a, -1, dtype=np.int64)
    a_pack[((a_i * q + a_kq) * L + a_l) * n_a + a_slot] = np.arange(
        len(a_coords), dtype=np.int64
    )
    b_kpl, b_j = b_pid // q, b_pid % q
    b_kp, b_l = b_kpl // L, b_kpl % L
    b_pack = np.full(p * q * L * n_b, -1, dtype=np.int64)
    b_pack[((b_kp * q + b_j) * L + b_l) * n_b + b_slot] = np.arange(
        len(b_coords), dtype=np.int64
    )

    # --- C ownership ------------------------------------------------------
    c_coords = c_layout.tile_coords
    c_dev = (
        rowb[c_coords[:, 0]].astype(np.int64) * q
        + colb[c_coords[:, 1]].astype(np.int64)
    )
    c_counts = np.bincount(c_dev, minlength=p * q)
    n_c = max(int(c_counts.max()) if len(c_coords) else 0, 1)
    c_starts = np.concatenate([[0], np.cumsum(c_counts)[:-1]])
    order_c = np.argsort(c_dev, kind="stable")
    pos = np.empty(len(c_dev), dtype=np.int64)
    pos[order_c] = np.arange(len(c_dev), dtype=np.int64) - c_starts[c_dev[order_c]]
    c_unpack = c_dev * n_c + pos
    c_keys = (
        c_coords[:, 0].astype(np.int64) * c_layout.ntc
        + c_coords[:, 1].astype(np.int64)
    )
    keyspace = int(c_layout.ntr) * int(c_layout.ntc) + 1
    c_devkey = c_dev[order_c] * keyspace + c_keys[order_c]

    # --- stacks over the gathered panels: one global enumeration ----------
    amat = sp.csr_matrix(
        (
            np.arange(1, len(a_coords) + 1, dtype=np.int64),
            (a_coords[:, 0].astype(np.int64), a_coords[:, 1].astype(np.int64)),
        ),
        shape=(mt, ktl),
    )
    bmat = sp.csr_matrix(
        (
            np.arange(1, len(b_coords) + 1, dtype=np.int64),
            (b_coords[:, 0].astype(np.int64), b_coords[:, 1].astype(np.int64)),
        ),
        shape=(ktl, ntc),
    )
    cr, cc, asl_g, bsl_g = enumerate_tile_triples(amat, bmat)

    def finish(stacks, s_max):
        if L == 1:  # legacy shapes (stacks [P, Q, s, 3])
            stacks = stacks.reshape(p, q, s_max, 3)
        return SummaPlan(
            p=p, q=q, n_a=n_a, n_b=n_b, n_c=n_c, s_max=s_max,
            a_pack=a_pack, b_pack=b_pack, stacks=stacks,
            c_unpack=c_unpack, layers=L,
        )

    if len(cr) == 0:
        stacks = np.zeros((p, q, L, 1, 3), dtype=np.int32)
        stacks[..., 0] = n_c
        return finish(stacks, 1)

    i_t = rowb[cr].astype(np.int64)
    j_t = colb[cc].astype(np.int64)
    l_t = klay[a_coords[asl_g, 1]]  # layer of the triple's k tile
    dev_t = i_t * q + j_t
    # gathered-panel slots: A slot = owner_col * n_a + local, B analogous
    a_gslot = a_kq[asl_g] * n_a + a_slot[asl_g]
    b_gslot = b_kp[bsl_g] * n_b + b_slot[bsl_g]
    dk = dev_t * keyspace + cr.astype(np.int64) * c_layout.ntc + cc
    ppos = np.searchsorted(c_devkey, dk)
    ok = (ppos < len(c_devkey)) & (
        c_devkey[np.minimum(ppos, max(len(c_devkey) - 1, 0))] == dk
    )
    cslot = np.where(ok, ppos - c_starts[dev_t], n_c)
    group = dev_t * L + l_t
    gcounts = np.bincount(group, minlength=p * q * L)
    s_max = max(int(gcounts.max()), 1)
    gstarts = np.concatenate([[0], np.cumsum(gcounts)[:-1]])
    order_t = np.lexsort((cslot, group))
    posg = np.arange(len(cr), dtype=np.int64) - gstarts[group[order_t]]
    flat = np.zeros((p * q * L * s_max, 3), dtype=np.int32)
    flat[:, 0] = n_c
    rowsel = group[order_t] * s_max + posg
    flat[rowsel, 0] = cslot[order_t]
    flat[rowsel, 1] = a_gslot[order_t]
    flat[rowsel, 2] = b_gslot[order_t]
    return finish(flat.reshape(p, q, L, s_max, 3), s_max)


def pad_summa_plan(
    plan: SummaPlan, n_a: int, n_b: int, n_c: int, s_max: int
) -> SummaPlan:
    """Re-pad a plan to larger capacities (so several group plans share one
    shard_map's static shapes). Gathered-panel slot ids are re-encoded for
    the new panel strides; padded stack rows are trash entries."""
    if (plan.n_a, plan.n_b, plan.n_c, plan.s_max) == (n_a, n_b, n_c, s_max):
        return plan
    assert plan.layers == 1, "pad_summa_plan: layered plans not padded (TAS)"
    p, q = plan.p, plan.q

    def repad_pack(flat: np.ndarray, old_n: int, new_n: int) -> np.ndarray:
        out = np.full((p, q, new_n), -1, dtype=flat.dtype)
        out[:, :, :old_n] = flat.reshape(p, q, old_n)
        return out.reshape(-1)

    st = plan.stacks
    new = np.zeros((p, q, s_max, 3), dtype=np.int32)
    new[..., 0] = n_c  # trash
    so = plan.s_max
    new[:, :, :so, 0] = np.where(st[..., 0] == plan.n_c, n_c, st[..., 0])
    new[:, :, :so, 1] = (st[..., 1] // plan.n_a) * n_a + st[..., 1] % plan.n_a
    new[:, :, :so, 2] = (st[..., 2] // plan.n_b) * n_b + st[..., 2] % plan.n_b
    c_unpack = (plan.c_unpack // plan.n_c) * n_c + plan.c_unpack % plan.n_c
    return SummaPlan(
        p=p, q=q, n_a=n_a, n_b=n_b, n_c=n_c, s_max=s_max,
        a_pack=repad_pack(plan.a_pack, plan.n_a, n_a),
        b_pack=repad_pack(plan.b_pack, plan.n_b, n_b),
        stacks=new, c_unpack=c_unpack,
    )


@partial(
    jax.jit,
    static_argnames=(
        "p", "q", "n_a", "n_b", "n_c", "tile", "s_max", "prec", "mesh",
        "layers",
    ),
)
def _summa_exec(
    a_store,  # [P, Q(, L), n_a, T, T] A tiles at their owners
    b_store,  # [P, Q(, L), n_b, T, T]
    stacks,  # [P, Q(, L), s_max, 3]
    *,
    p: int,
    q: int,
    n_a: int,
    n_b: int,
    n_c: int,
    tile: int,
    s_max: int,
    prec: str,
    mesh,
    layers: int = 1,
):
    """all_gather panels along the opposite axes, local tile stacks.

    With ``layers > 1`` the k range is pre-split over the layer mesh axis
    and per-layer C partials are psum'd over it — the 2.5D C-reduction of
    the reference (``multiply_3D``, ``src/mm/dbcsr_mm_3d.F:1038-1136``)
    composed with SUMMA."""
    from jax.sharding import PartitionSpec as P

    from ..dist.grid import AXIS_LAYER

    dtype = a_store.dtype
    precision = _PRECISIONS[prec]

    def local_fn(a, b, st):
        a = a.reshape(a.shape[-3:])  # [n_a, T, T] own A piece
        b = b.reshape(b.shape[-3:])
        st = st.reshape(st.shape[-2:])
        # gather A's row panel across the column axis, B's col panel across
        # the row axis (the SUMMA broadcasts, pipelined by XLA)
        a_full = jax.lax.all_gather(a, AXIS_COL)  # [Q, n_a, T, T]
        b_full = jax.lax.all_gather(b, AXIS_ROW)  # [P, n_b, T, T]
        a_full = a_full.reshape(q * n_a, tile, tile)
        b_full = b_full.reshape(p * n_b, tile, tile)
        ga = jnp.take(a_full, st[:, 1], axis=0)
        gb = jnp.take(b_full, st[:, 2], axis=0)
        prods = jax.lax.dot_general(
            ga, gb,
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.promote_types(jnp.float32, dtype),
            precision=precision,
        ).astype(dtype)
        c = jax.ops.segment_sum(prods, st[:, 0], num_segments=n_c + 1)
        if layers > 1:
            c = jax.lax.psum(c, AXIS_LAYER)
        return c[:n_c][None, None]

    spec_in = (
        P(AXIS_ROW, AXIS_COL, AXIS_LAYER)
        if layers > 1
        else P(AXIS_ROW, AXIS_COL)
    )
    # layer axis unmentioned in the out spec: the psum makes per-layer
    # outputs identical (replicated over the layer axis)
    summa = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(spec_in, spec_in, spec_in),
        out_specs=P(AXIS_ROW, AXIS_COL),
        check_vma=False,
    )
    return summa(a_store, b_store, stacks)


def execute_summa(
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
    dist: Distribution,
    k_dist: Optional[np.ndarray],
    cfg,
    *,
    mask_result: bool = False,
) -> jax.Array:
    """SUMMA execution path (any grid shape). Returns C's tile store."""
    from .engine import _align_old_c, _op_store

    tile = a.tile
    p, q = dist.grid.nprow, dist.grid.npcol
    layers = dist.grid.nlayer
    m_sizes = a.index.col_block_sizes if ta else a.index.row_block_sizes
    k_sizes = a.index.row_block_sizes if ta else a.index.col_block_sizes
    n_sizes = b.index.row_block_sizes if tb else b.index.col_block_sizes
    if k_dist is None:
        from ..dist.distribution import tile_dist_vector

        k_dist = tile_dist_vector(k_sizes, max(p, q), tile)

    rowb = dist_tile_bins(dist.row_dist, m_sizes, tile, majority=True)
    colb = dist_tile_bins(dist.col_dist, n_sizes, tile, majority=True)
    kb = dist_tile_bins(k_dist, k_sizes, tile, majority=True)

    a_st, a_coords, _ = _op_store(a, ta, ca)
    b_st, b_coords, _ = _op_store(b, tb, cb)
    c_lay = store_layout(c_index, tile)

    with timed("summa/plan"):
        from .plancache import (
            array_fingerprint,
            dist_fingerprint,
            get_plan_cache,
            index_fingerprint,
        )

        pcache = get_plan_cache()
        key = pcache.key(
            a.index, ta, b.index, tb,
            extra=(
                "summa",
                index_fingerprint(c_index),
                dist_fingerprint(dist),
                array_fingerprint(k_dist),
                tile,
                layers,
            ),
        )
        plan = pcache.get(key)
        if plan is None:
            plan = plan_summa(
                a_coords, b_coords, c_lay, rowb, colb, kb % q, kb % p,
                p, q, layers,
            )
            pcache.put(key, plan)

    # static message accounting (the reference's MPI statistics): each
    # device receives the other owners' panel pieces in the all_gathers
    st = get_stats()
    isz = a.data.dtype.itemsize
    ndev = p * q * layers
    st.record_comm("allgather_a", ndev * (q - 1), plan.n_a * tile * tile * isz)
    st.record_comm("allgather_b", ndev * (p - 1), plan.n_b * tile * tile * isz)
    if layers > 1:
        st.record_comm(
            "psum_c_layers", ndev * (layers - 1),
            plan.n_c * tile * tile * isz,
        )

    with timed("summa/exec"):
        shape_mid = (p, q, layers) if layers > 1 else (p, q)
        a_store = take_tiles(a_st, plan.a_pack, tile).reshape(
            *shape_mid, plan.n_a, tile, tile
        )
        b_store = take_tiles(b_st, plan.b_pack, tile).reshape(
            *shape_mid, plan.n_b, tile, tile
        )
        c_tiles = _summa_exec(
            a_store, b_store, jnp.asarray(plan.stacks),
            p=p, q=q, n_a=plan.n_a, n_b=plan.n_b, n_c=plan.n_c,
            tile=tile, s_max=plan.s_max, prec=cfg.matmul_precision,
            mesh=dist.grid.mesh, layers=layers,
        )
        prod = take_tiles(
            c_tiles.reshape(p * q * plan.n_c, tile, tile), plan.c_unpack, tile
        )
        if mask_result and c_lay.n_tiles:
            prod = prod * valid_mask(c_index, tile).astype(prod.dtype)
        get_stats().hardware_flops += 2.0 * float(
            (plan.stacks[..., 0] < plan.n_c).sum()
        ) * tile**3

    old = _align_old_c(c, c_index, tile)
    out = jnp.asarray(alpha, dtype=a.dtype) * prod
    if old is not None:
        out = out + jnp.asarray(beta, dtype=a.dtype) * old
    return out
