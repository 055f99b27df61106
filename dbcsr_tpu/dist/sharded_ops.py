"""Sharded elementwise / reduction / pattern-changing ops (v3).

Ops that act DIRECTLY on owner-sharded tile stores ([ndev, n_max, T, T]
with ``NamedSharding(mesh, P(('pr','pc'),))``, see ``sharded.py``) without
ever gathering a matrix onto one host. The reference's elementwise layer
(``src/ops/dbcsr_operations.F:109-125``) works on each rank's local blocks
with scalar MPI reductions at the end; this library's form is the same
shape: per-device tile arithmetic inside ``jax.shard_map``, with
``lax.psum``/``pmax`` for the scalar reductions.

The key structural fact: pattern-changing results (add's index union,
hadamard's intersection, filter's data-dependent survivors) keep the same
owner bins as their operands — a tile's owner depends only on its (tile
row, tile col) through the distribution's bins — so the remap from operand
layout to result layout is OWNER-LOCAL by construction. Every op below
moves zero bytes between devices outside the final scalar reductions.

Block-granular semantics (per-block norms for ``sharded_filter``) reuse the
indicator-matmul machinery of ``block/tileops.py``, with the indicator
stacks resharded once per (index, dist) and the tiny [amax, bmax] combine
on host — the sharded analog of the reference's norms kernels
(``src/acc/cuda_hip/calculate_norms.cpp``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..block.bcsr import BCSRMatrix, SYM_NONE
from ..block.index import BCSRIndex, build_index, merge_index
from ..block.store import store_layout
from ..block.tileops import tile_align_map, tile_block_info, valid_mask
from ..core.errors import dbcsr_assert
from ..core.timing import timed
from .distribution import Distribution
from .grid import AXIS_COL, AXIS_ROW
from .sharded import (
    ShardLayout,
    mesh_sharding,
    shard_layout,
    shard_store_with_layout,
    unshard_store_with_layout,
)

__all__ = [
    "ShardedMatrix",
    "shard_matrix",
    "build_sharded_multiply",
    "sharded_multiply",
    "build_sharded_add",
    "sharded_add",
    "build_sharded_hadamard",
    "sharded_hadamard",
    "sharded_scale",
    "build_sharded_scale_by_vector",
    "sharded_scale_by_vector",
    "sharded_function_of_elements",
    "sharded_trace",
    "sharded_dot",
    "sharded_frobenius",
    "sharded_maxabs",
    "sharded_block_norms",
    "sharded_filter",
    "sharded_checkpoint_write",
    "sharded_checkpoint_read",
]

_DEV = P((AXIS_ROW, AXIS_COL))
_OOB = np.int32(np.iinfo(np.int32).max)


@dataclass(frozen=True)
class ShardedMatrix:
    """A BCSR matrix whose tile data lives owner-sharded on the mesh.

    ``data`` is [ndev, n_max, T, T] laid out by ``shard`` (device-major,
    zero padded); ``index`` stays replicated host metadata, exactly like
    the reference keeps the (small) block index on every rank while the
    ``data_area`` is distributed."""

    name: str
    index: BCSRIndex
    tile: int
    dist: Distribution
    shard: ShardLayout
    data: jax.Array
    sym: str = SYM_NONE
    #: imaginary shard store for SPLIT-COMPLEX emulation (backends that
    #: reject complex arrays; see block/bcsr.py) — None = real/native
    data_im: Optional[jax.Array] = None
    cdtype: Optional[str] = None

    @property
    def nblks(self) -> int:
        return self.index.nblks

    @property
    def dtype(self):
        if self.data_im is not None:
            return np.dtype(self.cdtype)
        return self.data.dtype

    @property
    def is_complex_emulated(self) -> bool:
        return self.data_im is not None

    def parts(self) -> Tuple["ShardedMatrix", "ShardedMatrix"]:
        """(re, im) as REAL sharded matrices sharing index/shard layout."""
        dbcsr_assert(self.is_complex_emulated, "not an emulated matrix")
        re = replace(
            self, data=self.data, data_im=None, cdtype=None,
            name=f"{self.name}.re",
        )
        im = replace(
            self, data=self.data_im, data_im=None, cdtype=None,
            name=f"{self.name}.im",
        )
        return re, im

    @staticmethod
    def combine(
        re: "ShardedMatrix", im: "ShardedMatrix", cdtype, *,
        name: str = "matrix",
    ) -> "ShardedMatrix":
        return replace(
            re, data_im=im.data, cdtype=np.dtype(cdtype).name, name=name
        )

    @property
    def mesh(self):
        return self.dist.grid.mesh

    def with_data(self, data: jax.Array) -> "ShardedMatrix":
        dbcsr_assert(
            self.data_im is None,
            "with_data on a split-complex sharded matrix: use combine",
        )
        return replace(self, data=data)

    def to_local(self) -> BCSRMatrix:
        """Gather back to a replicated local store."""
        data = unshard_store_with_layout(self.data, self.shard, self.tile)
        if self.data_im is not None:
            im = unshard_store_with_layout(
                self.data_im, self.shard, self.tile
            )
            return BCSRMatrix(
                name=self.name, index=self.index, data=data, sym=self.sym,
                dist=self.dist, data_im=im, cdtype=self.cdtype,
            )
        return BCSRMatrix(
            name=self.name, index=self.index, data=data, sym=self.sym,
            dist=self.dist,
        )


def shard_matrix(m: BCSRMatrix, dist: Distribution) -> ShardedMatrix:
    """Owner-shard a local matrix over ``dist``'s grid.

    On a 2.5D grid (``nlayer > 1``) the owner partition lives on the
    (pr, pc) plane and the tile data is REPLICATED across the layer axis
    (the layer dimension is unmentioned in the ``P(('pr','pc'),)``
    sharding): at-rest matrices compose with the layered executors
    (``sharded_multiply`` k-splits across layers inside jit) exactly like
    the reference's 3D driver composes with its 2-D-distributed storage
    (``/root/reference/src/mm/dbcsr_mm_3d.F:1038-1136``)."""
    sl = shard_layout(m.index, m.tile, dist)
    if m.is_complex_emulated:
        re, im = m.parts()
        return ShardedMatrix.combine(
            shard_matrix(re, dist), shard_matrix(im, dist), m.dtype,
            name=m.name,
        )
    data = shard_store_with_layout(m, sl, dist.grid.mesh)
    return ShardedMatrix(
        name=m.name, index=m.index, tile=m.tile, dist=dist, shard=sl,
        data=data, sym=m.sym,
    )


# ---------------------------------------------------------------------------
# owner-local remap between two shard layouts with the same bins
# ---------------------------------------------------------------------------

def _remap_table(
    dst_index: BCSRIndex, dst_sl: ShardLayout,
    src_index: BCSRIndex, src_sl: ShardLayout, tile: int,
) -> np.ndarray:
    """int32 [ndev, n_max_dst]: for every destination sharded position, the
    LOCAL source slot on the same device holding that tile (OOB sentinel →
    zero fill). Raises if any shared tile has different owners (layouts
    built from different distributions)."""
    dst_keys = store_layout(dst_index, tile).tile_keys()
    src_keys = store_layout(src_index, tile).tile_keys()
    amap = tile_align_map(dst_keys, src_keys)  # dst slot -> src slot | -1
    tbl = np.full(dst_sl.ndev * dst_sl.n_max, _OOB, dtype=np.int32)
    pos_valid = dst_sl.slot_of_pos >= 0
    dslot = dst_sl.slot_of_pos[pos_valid]
    sslot = amap[dslot]
    hit = sslot >= 0
    if hit.any():
        dbcsr_assert(
            np.array_equal(
                src_sl.owner_of_slot[sslot[hit]],
                dst_sl.owner_of_slot[dslot[hit]],
            ),
            "shard layouts disagree on tile owners — reshard one operand "
            "onto the other's distribution first",
        )
        idx = np.flatnonzero(pos_valid)[hit]
        tbl[idx] = src_sl.local_of_slot[sslot[hit]]
    return tbl.reshape(dst_sl.ndev, dst_sl.n_max)


def _put_dev(mesh, arr: np.ndarray) -> jax.Array:
    """Place a [ndev, ...] host table device-sharded along axis 0."""
    return jax.device_put(jnp.asarray(arr), mesh_sharding(mesh))


def _local_take(x: jax.Array, tbl: jax.Array) -> jax.Array:
    """Per-device tile gather with OOB → zero fill."""
    return jnp.take(x, tbl, axis=0, mode="fill", fill_value=0)


def _shard_constant(
    store: jax.Array, sl: ShardLayout, tile: int, mesh
) -> jax.Array:
    """A local-store-ordered constant ([n_tiles, ...]) re-laid-out into the
    sharded position order (zero padding)."""
    if store.shape[0] == 0:  # empty matrix: every position is padding
        arr = jnp.zeros(
            (sl.ndev, sl.n_max) + store.shape[1:], dtype=store.dtype
        )
        return jax.device_put(arr, mesh_sharding(mesh))
    take = np.where(sl.slot_of_pos >= 0, sl.slot_of_pos, _OOB).astype(
        np.int32
    )
    arr = jnp.take(store, jnp.asarray(take), axis=0, mode="fill", fill_value=0)
    arr = arr.reshape((sl.ndev, sl.n_max) + store.shape[1:])
    return jax.device_put(arr, mesh_sharding(mesh))


def _sharded_valid_mask(sm: ShardedMatrix) -> jax.Array:
    """Cached sharded validity mask (1 on stored-block positions)."""
    key = ("sharded_valid_mask", sm.tile, sm.shard.token)
    return sm.index._cached(
        key,
        lambda: _shard_constant(
            valid_mask(sm.index, sm.tile), sm.shard, sm.tile, sm.mesh
        ),
    )


def _check_compatible(a: ShardedMatrix, b: ShardedMatrix) -> None:
    dbcsr_assert(a.tile == b.tile, "tile sizes differ")
    dbcsr_assert(a.sym == b.sym, "sharded ops need matching symmetry")
    dbcsr_assert(
        a.mesh is b.mesh or a.mesh == b.mesh, "operands on different meshes"
    )
    dbcsr_assert(
        np.array_equal(a.index.row_block_sizes, b.index.row_block_sizes)
        and np.array_equal(a.index.col_block_sizes, b.index.col_block_sizes),
        "incompatible block structures",
    )


# ---------------------------------------------------------------------------
# multiply on sharded matrices
# ---------------------------------------------------------------------------

def _reshard_positions(
    x_sh: jax.Array, src_sl: ShardLayout, dst_sl: ShardLayout, tile: int,
    mesh,
) -> jax.Array:
    """Move a sharded store between two layouts OF THE SAME INDEX (e.g. a
    matrix's at-rest owner layout vs the executor's k-binned layout). A
    position-level gather; XLA inserts the implied collectives."""
    same = (
        src_sl.token == dst_sl.token
        if src_sl.token and dst_sl.token
        else (
            src_sl.n_max == dst_sl.n_max
            and src_sl.pos_of_slot.tobytes() == dst_sl.pos_of_slot.tobytes()
        )
    )
    if same:
        return x_sh
    take = np.full(dst_sl.ndev * dst_sl.n_max, _OOB, dtype=np.int32)
    valid = dst_sl.slot_of_pos >= 0
    take[valid] = src_sl.pos_of_slot[dst_sl.slot_of_pos[valid]]
    flat = x_sh.reshape(src_sl.ndev * src_sl.n_max, tile, tile)
    out = jnp.take(
        flat, jnp.asarray(take), axis=0, mode="fill", fill_value=0
    ).reshape(dst_sl.ndev, dst_sl.n_max, tile, tile)
    return jax.lax.with_sharding_constraint(out, mesh_sharding(mesh))


def build_sharded_multiply(
    transa: str,
    transb: str,
    a: ShardedMatrix,
    b: ShardedMatrix,
    *,
    algo: Optional[str] = None,
    k_dist: Optional[np.ndarray] = None,
):
    """Plan op(A)·op(B) entirely on sharded stores: the distributed
    executor (Cannon/SUMMA over the mesh) is planned from the indices, and
    the operands are resharded from their at-rest owner layouts onto the
    executor's k-binned panel layouts inside jit (the reference's
    ``make_images`` alltoall, ``src/mm/dbcsr_mm_cannon.F:146``).

    Returns ``(c_index, c_shard, fn)`` with ``fn(a_sh, b_sh) -> c_sh``.
    """
    from ..mm.engine import build_distributed_executor

    dbcsr_assert(a.tile == b.tile, "tile sizes differ")
    dbcsr_assert(a.sym == SYM_NONE and b.sym == SYM_NONE,
                 "desymmetrize before sharded multiply")
    tile, mesh = a.tile, a.mesh
    # metadata stand-ins: the executor reads only index/layout at plan time
    a_meta = BCSRMatrix(
        name=a.name, index=a.index,
        data=jnp.zeros((0, tile, tile), a.dtype),
    )
    b_meta = BCSRMatrix(
        name=b.name, index=b.index,
        data=jnp.zeros((0, tile, tile), b.dtype),
    )
    exec_fn, c_index, eff = build_distributed_executor(
        transa, transb, a_meta, b_meta, a.dist, algo=algo, k_dist=k_dist,
        sharded=True,
    )
    sl_a, sl_b, sl_c = exec_fn.shard_a, exec_fn.shard_b, exec_fn.shard_c
    # bind only the shard LAYOUTS (not the ShardedMatrix objects): the
    # closure may be plan-cached, and capturing a/b would pin their full
    # HBM tile stores for the cache entry's lifetime
    at_rest_a, at_rest_b = a.shard, b.shard

    def fn(a_sh, b_sh):
        xa = _reshard_positions(a_sh, at_rest_a, sl_a, tile, mesh)
        xb = _reshard_positions(b_sh, at_rest_b, sl_b, tile, mesh)
        return exec_fn(xa, xb)

    fn.eff_flops = eff
    return c_index, sl_c, fn


def sharded_multiply(
    transa: str,
    transb: str,
    alpha,
    a: ShardedMatrix,
    b: ShardedMatrix,
    beta=0.0,
    c: Optional[ShardedMatrix] = None,
) -> ShardedMatrix:
    """``C = alpha * op(A)·op(B) [+ beta * C]`` on sharded matrices
    (``dbcsr_multiply`` with distributed data residency end to end)."""
    if (
        a.is_complex_emulated
        or b.is_complex_emulated
        or (c is not None and c.is_complex_emulated)
    ):
        return _emu_s_multiply(transa, transb, alpha, a, b, beta, c)
    # content-keyed plan cache (the one-shot-multiply analog of the local
    # engine's, mm/engine.py; iterative sharded loops then pay zero host
    # planning per step without managing build_sharded_multiply handles)
    from ..core.config import config_fingerprint
    from ..mm.plancache import dist_fingerprint, get_plan_cache

    pcache = get_plan_cache()
    # the executor bakes config at build time (precision, kernel driver,
    # bf16 inputs, panel knobs, algorithm, ...): key on every public
    # config field + its D/E/U provenance (knob resolution defers to the
    # tuned table for default-provenance fields) so config_override
    # between calls re-plans instead of silently reusing a stale
    # executor — see core.config.config_fingerprint
    cfg_fp = config_fingerprint()
    key = pcache.key(
        a.index, transa.upper() != "N", b.index, transb.upper() != "N",
        extra=(
            "sharded_multiply", dist_fingerprint(a.dist),
            a.shard.token, b.shard.token, a.tile,
            np.dtype(a.dtype).name, np.dtype(b.dtype).name,
            cfg_fp,
        ),
    )
    cached = pcache.get(key)
    if cached is not None:
        c_index, c_sl, fn = cached
    else:
        c_index, c_sl, fn = build_sharded_multiply(transa, transb, a, b)
        pcache.put(key, (c_index, c_sl, fn))
    out = ShardedMatrix(
        name=f"{a.name}*{b.name}", index=c_index, tile=a.tile, dist=a.dist,
        shard=c_sl, data=fn(a.data, b.data), sym=SYM_NONE,
    )
    if alpha != 1.0:
        out = sharded_scale(out, alpha)
    if c is not None:
        # always merge C's index — even at beta == 0 the result's sparsity
        # pattern retains C's (zeroed) blocks, matching the local engine
        # (engine.py merges c.index into c_index regardless of beta) and the
        # reference's beta-scaling semantics (src/mm/dbcsr_mm.F:630-709)
        out = sharded_add(1.0, out, beta, c)
    return out


# ---------------------------------------------------------------------------
# add (index union) / hadamard (index intersection)
# ---------------------------------------------------------------------------

def build_sharded_add(
    a: ShardedMatrix, b: ShardedMatrix
) -> Tuple[BCSRIndex, ShardLayout, Callable]:
    """Plan alpha*A + beta*B on sharded stores: the result's pattern is the
    index union (``dbcsr_add``), its shard layout shares the operands'
    owner bins, and the two remaps are owner-local tile gathers.

    Returns (c_index, c_shard, fn) with
    ``fn(x_sh, y_sh, alpha=1.0, beta=1.0) -> c_sh`` jit/scan-safe.
    """
    _check_compatible(a, b)
    with timed("sharded_add_plan"):
        c_index, _, _ = merge_index(a.index, b.index)
        c_sl = shard_layout(c_index, a.tile, a.dist)
        mesh = a.mesh
        ta = _put_dev(mesh, _remap_table(c_index, c_sl, a.index, a.shard, a.tile))
        tb = _put_dev(mesh, _remap_table(c_index, c_sl, b.index, b.shard, b.tile))
        dtype = jnp.result_type(a.dtype, b.dtype)

    def local(x, y, ix, iy, al, be):
        gx = _local_take(x[0], ix[0]).astype(dtype)
        gy = _local_take(y[0], iy[0]).astype(dtype)
        return (al.astype(dtype) * gx + be.astype(dtype) * gy)[None]

    smapped = jax.shard_map(
        local, mesh=mesh,
        in_specs=(_DEV, _DEV, _DEV, _DEV, P(), P()),
        out_specs=_DEV,
    )

    def fn(x_sh, y_sh, alpha=1.0, beta=1.0):
        return smapped(
            x_sh, y_sh, ta, tb, jnp.asarray(alpha), jnp.asarray(beta)
        )

    return c_index, c_sl, fn


def sharded_add(alpha, a: ShardedMatrix, beta, b: ShardedMatrix) -> ShardedMatrix:
    if a.is_complex_emulated or b.is_complex_emulated:
        return _emu_s_add(alpha, a, beta, b)
    c_index, c_sl, fn = build_sharded_add(a, b)
    return ShardedMatrix(
        name=a.name, index=c_index, tile=a.tile, dist=a.dist, shard=c_sl,
        data=fn(a.data, b.data, alpha, beta), sym=a.sym,
    )


def build_sharded_hadamard(
    a: ShardedMatrix, b: ShardedMatrix
) -> Tuple[BCSRIndex, ShardLayout, Callable]:
    """Plan the elementwise product on the pattern intersection
    (``dbcsr_hadamard_product``). Exact without masking: a position covered
    in only one operand multiplies against that operand's zero padding."""
    _check_compatible(a, b)
    with timed("sharded_hadamard_plan"):
        pm = a.index.pattern().astype(bool).multiply(
            b.index.pattern().astype(bool)
        ).tocsr()
        pm.sort_indices()
        rows = np.repeat(
            np.arange(pm.shape[0], dtype=np.int32),
            np.diff(pm.indptr).astype(np.int64),
        )
        c_index, _ = build_index(
            rows, pm.indices.astype(np.int32),
            a.index.row_block_sizes, a.index.col_block_sizes,
        )
        c_sl = shard_layout(c_index, a.tile, a.dist)
        mesh = a.mesh
        ta = _put_dev(mesh, _remap_table(c_index, c_sl, a.index, a.shard, a.tile))
        tb = _put_dev(mesh, _remap_table(c_index, c_sl, b.index, b.shard, b.tile))

    def local(x, y, ix, iy):
        return (_local_take(x[0], ix[0]) * _local_take(y[0], iy[0]))[None]

    smapped = jax.shard_map(
        local, mesh=mesh,
        in_specs=(_DEV, _DEV, _DEV, _DEV), out_specs=_DEV,
    )

    def fn(x_sh, y_sh):
        return smapped(x_sh, y_sh, ta, tb)

    return c_index, c_sl, fn


def sharded_hadamard(a: ShardedMatrix, b: ShardedMatrix) -> ShardedMatrix:
    if a.is_complex_emulated or b.is_complex_emulated:
        return _emu_s_hadamard(a, b)
    c_index, c_sl, fn = build_sharded_hadamard(a, b)
    return ShardedMatrix(
        name=a.name, index=c_index, tile=a.tile, dist=a.dist, shard=c_sl,
        data=fn(a.data, b.data), sym=a.sym,
    )


# ---------------------------------------------------------------------------
# same-pattern elementwise
# ---------------------------------------------------------------------------

def sharded_scale(sm: ShardedMatrix, alpha) -> ShardedMatrix:
    """alpha * A (``dbcsr_scale``): pure local arithmetic."""
    if sm.is_complex_emulated:
        al = complex(alpha)
        re, im = sm.parts()
        rr = re.with_data(al.real * re.data - al.imag * im.data)
        ii = im.with_data(al.imag * re.data + al.real * im.data)
        return ShardedMatrix.combine(rr, ii, sm.dtype, name=sm.name)
    return sm.with_data(sm.data * jnp.asarray(alpha, sm.dtype))


def build_sharded_scale_by_vector(
    sm: ShardedMatrix, side: str = "right"
) -> Callable:
    """Plan row/col scaling (``dbcsr_scale_by_vector``): per-device tile
    coordinates are plan constants, the full vector is a (replicated)
    runtime argument re-tiled locally. Returns ``fn(x_sh, vec) -> x_sh``."""
    dbcsr_assert(side in ("left", "right"), "side must be left|right")
    sl, t, mesh = sm.shard, sm.tile, sm.mesh
    lay = store_layout(sm.index, t)
    axis = 0 if side == "left" else 1
    n_full = sm.index.nfullrows if side == "left" else sm.index.nfullcols
    ntiles_dim = lay.ntr if side == "left" else lay.ntc
    coords = np.full(sl.ndev * sl.n_max, ntiles_dim, dtype=np.int32)  # pad row
    pos_valid = sl.slot_of_pos >= 0
    coords[pos_valid] = lay.tile_coords[sl.slot_of_pos[pos_valid], axis]
    ct = _put_dev(mesh, coords.reshape(sl.ndev, sl.n_max))

    def local(x, c, v):
        vt = jnp.zeros(((ntiles_dim + 1) * t,), dtype=x.dtype)
        vt = vt.at[:n_full].set(v.astype(x.dtype).reshape(n_full))
        per = jnp.take(vt.reshape(ntiles_dim + 1, t), c[0], axis=0)
        if side == "left":
            return (x[0] * per[:, :, None])[None]
        return (x[0] * per[:, None, :])[None]

    smapped = jax.shard_map(
        local, mesh=mesh, in_specs=(_DEV, _DEV, P()), out_specs=_DEV
    )

    def fn(x_sh, vec):
        return smapped(x_sh, ct, jnp.asarray(vec))

    return fn


def sharded_scale_by_vector(
    sm: ShardedMatrix, vec, side: str = "right"
) -> ShardedMatrix:
    if sm.is_complex_emulated:
        v = np.asarray(vec)
        re, im = sm.parts()
        fn = build_sharded_scale_by_vector(re, side)
        rr = re.with_data(fn(re.data, v.real))
        ii = im.with_data(fn(im.data, v.real))
        if np.iscomplexobj(v) and np.abs(v.imag).max() > 0:
            rr = rr.with_data(rr.data - fn(im.data, v.imag))
            ii = ii.with_data(ii.data + fn(re.data, v.imag))
        return ShardedMatrix.combine(rr, ii, sm.dtype, name=sm.name)
    return sm.with_data(build_sharded_scale_by_vector(sm, side)(sm.data, vec))


def sharded_function_of_elements(sm: ShardedMatrix, fn) -> ShardedMatrix:
    """Elementwise function on stored elements
    (``dbcsr_function_of_elements``): local apply, sharded validity mask
    keeps padding at zero when fn(0) != 0."""
    from ..ops.arithmetic import ELEMENT_FUNCTIONS

    dbcsr_assert(
        not sm.is_complex_emulated,
        "function_of_elements is not defined for split-complex matrices",
    )
    if isinstance(fn, str):
        dbcsr_assert(
            fn in ELEMENT_FUNCTIONS, f"unknown element function {fn!r}"
        )
        fn = ELEMENT_FUNCTIONS[fn]
    vm = _sharded_valid_mask(sm)
    out = fn(sm.data)
    return sm.with_data(jnp.where(vm > 0.5, out, jnp.zeros_like(out)))


# ---------------------------------------------------------------------------
# scalar reductions
# ---------------------------------------------------------------------------

def _assert_nonsym(sm: ShardedMatrix, what: str) -> None:
    dbcsr_assert(
        sm.sym == SYM_NONE,
        f"sharded {what} needs a desymmetrized matrix (canonical stores "
        "hold one triangle)",
    )


def sharded_trace(sm: ShardedMatrix):
    """Tr(A): per-device partial over its diagonal tiles + psum
    (``dbcsr_trace``; the reference reduces per-rank partials the same
    way)."""
    if sm.is_complex_emulated:
        re, im = sm.parts()
        return complex(sharded_trace(re)) + 1j * complex(sharded_trace(im))
    sl, t, mesh = sm.shard, sm.tile, sm.mesh
    key = ("sharded_trace_tbl", t, sl.token)

    def mk():
        lay = store_layout(sm.index, t)
        diag = lay.tile_coords[:, 0] == lay.tile_coords[:, 1]
        tbl = np.full((sl.ndev, sl.n_max), _OOB, dtype=np.int32)
        n_diag = np.zeros(sl.ndev, dtype=np.int64)
        for s in np.flatnonzero(diag):
            d = int(sl.owner_of_slot[s])
            tbl[d, n_diag[d]] = sl.local_of_slot[s]
            n_diag[d] += 1
        d_max = max(int(n_diag.max(initial=0)), 1)
        return _put_dev(mesh, tbl[:, :d_max])

    tbl = sm.index._cached(key, mk)

    def local(x, c):
        g = _local_take(x[0], c[0])
        part = jnp.trace(g, axis1=1, axis2=2).sum()
        return jax.lax.psum(jax.lax.psum(part, AXIS_ROW), AXIS_COL)

    out = jax.shard_map(
        local, mesh=mesh, in_specs=(_DEV, _DEV), out_specs=P()
    )(sm.data, tbl)
    return complex(out) if jnp.iscomplexobj(out) else float(out)


def sharded_dot(a: ShardedMatrix, b: ShardedMatrix):
    """Frobenius inner product Tr(A^H B) (``dbcsr_dot``): remap B onto A's
    layout (owner-local), multiply, psum."""
    _check_compatible(a, b)
    _assert_nonsym(a, "dot")
    if a.is_complex_emulated or b.is_complex_emulated:
        cdtype = np.promote_types(a.dtype, b.dtype)
        ar, ai = _emu_s_parts(a, cdtype)
        br, bi = _emu_s_parts(b, cdtype)
        re = sharded_dot(ar, br) + sharded_dot(ai, bi)
        im = sharded_dot(ar, bi) - sharded_dot(ai, br)
        return complex(re) + 1j * complex(im)
    tbl = _put_dev(
        a.mesh, _remap_table(a.index, a.shard, b.index, b.shard, a.tile)
    )

    def local(x, y, iy):
        gy = _local_take(y[0], iy[0])
        part = jnp.sum(jnp.conj(x[0]) * gy)
        return jax.lax.psum(jax.lax.psum(part, AXIS_ROW), AXIS_COL)

    out = jax.shard_map(
        local, mesh=a.mesh, in_specs=(_DEV, _DEV, _DEV), out_specs=P()
    )(a.data, b.data, tbl)
    return complex(out) if jnp.iscomplexobj(out) else float(out)


def sharded_frobenius(sm: ShardedMatrix) -> float:
    """Frobenius norm: local sum of |x|², global psum, sqrt."""
    _assert_nonsym(sm, "frobenius norm")
    if sm.is_complex_emulated:
        re, im = sm.parts()
        return float(np.hypot(sharded_frobenius(re), sharded_frobenius(im)))

    def local(x):
        part = jnp.sum((x * jnp.conj(x)).real)
        return jax.lax.psum(jax.lax.psum(part, AXIS_ROW), AXIS_COL)

    out = jax.shard_map(
        local, mesh=sm.mesh, in_specs=(_DEV,), out_specs=P()
    )(sm.data)
    return float(jnp.sqrt(out))


def sharded_maxabs(sm: ShardedMatrix) -> float:
    """max |a_ij| (``dbcsr_maxabs``): local max, global pmax."""
    _assert_nonsym(sm, "maxabs norm")
    if sm.is_complex_emulated:
        re, im = sm.parts()
        sq = re.with_data(re.data * re.data + im.data * im.data)
        return float(np.sqrt(sharded_maxabs(sq)))

    def local(x):
        part = jnp.max(jnp.abs(x)) if x.size else jnp.float32(0)
        return jax.lax.pmax(jax.lax.pmax(part, AXIS_ROW), AXIS_COL)

    out = jax.shard_map(
        local, mesh=sm.mesh, in_specs=(_DEV,), out_specs=P()
    )(sm.data)
    return float(out)


# ---------------------------------------------------------------------------
# sharded checkpoint I/O
# ---------------------------------------------------------------------------

def sharded_checkpoint_write(sm: ShardedMatrix, directory: str) -> None:
    """Checkpoint a sharded matrix WITHOUT gathering: the replicated index
    metadata goes to ``index.npz`` and every device's tile shard to its own
    ``shard_<d>.npy`` — each process writes only its ADDRESSABLE shards, so
    on a multi-host mesh this is collective per-host I/O, the analog of the
    reference's MPI-IO checkpoint (``dbcsr_binary_write``,
    ``src/ops/dbcsr_io.F:576`` via ``mp_file_*``)."""
    import os

    os.makedirs(directory, exist_ok=True)
    idx = sm.index

    def dev_of(shard) -> int:
        ix = shard.index[0]
        return int(ix.start) if isinstance(ix, slice) else int(ix)

    shards = list(sm.data.addressable_shards)
    if min(dev_of(s) for s in shards) == 0:
        # exactly one process holds device 0: it writes the metadata
        np.savez(
            os.path.join(directory, "index.npz"),
            name=sm.name,
            sym=sm.sym,
            tile=np.int64(sm.tile),
            ndev=np.int64(sm.shard.ndev),
            n_max=np.int64(sm.shard.n_max),
            dtype=np.dtype(sm.dtype).str,
            emulated=np.int64(1 if sm.is_complex_emulated else 0),
            row_block_sizes=idx.row_block_sizes,
            col_block_sizes=idx.col_block_sizes,
            blk_rows=idx.blk_rows,
            col_idx=idx.col_idx,
            row_dist=sm.dist.row_dist,
            col_dist=sm.dist.col_dist,
        )
    def write_unique(shard_list, prefix):
        # on a 2.5D mesh each (pr, pc) owner shard is replicated across
        # the layer axis -> appears once per layer; write each row once
        seen = set()
        for s in shard_list:
            d = dev_of(s)
            if d in seen:
                continue
            seen.add(d)
            np.save(
                os.path.join(directory, f"{prefix}_{d}.npy"),
                np.asarray(s.data)[0],
            )

    write_unique(shards, "shard")
    if sm.is_complex_emulated:
        write_unique(sm.data_im.addressable_shards, "shard_im")


def sharded_checkpoint_read(directory: str, grid) -> ShardedMatrix:
    """Restore a sharded matrix written by :func:`sharded_checkpoint_write`
    onto ``grid``'s mesh (same shape). Shards are loaded per device and
    placed without ever materializing the global store contiguously on one
    device."""
    import os

    from ..block.index import build_index
    from .distribution import Distribution

    z = np.load(os.path.join(directory, "index.npz"))
    tile = int(z["tile"])
    index, _ = build_index(
        z["blk_rows"], z["col_idx"], z["row_block_sizes"],
        z["col_block_sizes"],
    )
    dist = Distribution(
        grid=grid, row_dist=z["row_dist"], col_dist=z["col_dist"]
    )
    sl = shard_layout(index, tile, dist)
    dbcsr_assert(
        sl.ndev == int(z["ndev"]) and sl.n_max == int(z["n_max"]),
        "checkpoint grid shape does not match the target mesh",
    )
    dtype = np.dtype(str(z["dtype"]))

    sharding = mesh_sharding(grid.mesh)
    emulated = bool(int(z["emulated"])) if "emulated" in z else False
    real_dtype = np.zeros(0, dtype=dtype).real.dtype if emulated else dtype

    def mk(prefix):
        return jax.make_array_from_callback(
            (sl.ndev, sl.n_max, tile, tile),
            sharding,
            lambda idx_: np.load(
                os.path.join(
                    directory,
                    f"{prefix}_"
                    f"{int(idx_[0].start if isinstance(idx_[0], slice) else idx_[0])}.npy",
                )
            )[None].astype(real_dtype),
        )

    data = mk("shard")
    data_im = mk("shard_im") if emulated else None
    return ShardedMatrix(
        name=str(z["name"]), index=index, tile=tile, dist=dist,
        shard=sl, data=data, sym=str(z["sym"]),
        data_im=data_im,
        cdtype=np.dtype(dtype).name if emulated else None,
    )


# ---------------------------------------------------------------------------
# pattern-changing: per-block norms → filter
# ---------------------------------------------------------------------------

def sharded_block_norms(sm: ShardedMatrix) -> np.ndarray:
    """Per-block Frobenius-norm² from the sharded store: the indicator
    stacks (J, I) are resharded once per layout, each device computes its
    tiles' [amax, bmax] partials (two batched matmuls), and the tiny
    per-block combine runs on host (``block_sums_sq``'s sharded twin)."""
    if sm.is_complex_emulated:
        re, im = sm.parts()
        return sharded_block_norms(re) + sharded_block_norms(im)
    info = tile_block_info(sm.index, sm.tile)
    if sm.index.nblks == 0:
        return np.zeros(0, dtype=np.float32)
    sl, t, mesh = sm.shard, sm.tile, sm.mesh
    key = ("sharded_block_norm_tables", t, sl.token)

    def mk():
        J_sh = _shard_constant(info.J_dev, sl, t, mesh)
        I_sh = _shard_constant(info.I_dev, sl, t, mesh)
        # bid in sharded position order (host combine side)
        bid = np.full(
            (sl.ndev * sl.n_max,) + info.bid.shape[1:], -1, dtype=np.int64
        )
        pos_valid = sl.slot_of_pos >= 0
        bid[pos_valid] = info.bid[sl.slot_of_pos[pos_valid]]
        return J_sh, I_sh, bid

    J_sh, I_sh, bid = sm.index._cached(key, mk)

    def local(x, Jd, Id):
        # HIGHEST precision: true-f32 norms (see tileops._per_tile_block_sums)
        x2 = (x[0] * jnp.conj(x[0])).real.astype(jnp.float32)
        y = jnp.einsum(
            "tia,tij->taj", Jd[0], x2, precision=jax.lax.Precision.HIGHEST
        )
        return jnp.einsum(
            "taj,tjb->tab", y, Id[0], precision=jax.lax.Precision.HIGHEST
        )[None]

    z = jax.shard_map(
        local, mesh=mesh, in_specs=(_DEV, _DEV, _DEV), out_specs=_DEV
    )(sm.data, J_sh, I_sh)
    if not z.is_fully_addressable:
        # multi-process mesh: the host combine needs every device's
        # partials — reshard to fully-replicated, read the local copy
        z = jax.jit(
            lambda v: v,
            out_shardings=jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec()
            ),
        )(z)
        z = z.addressable_shards[0].data
    zh = np.asarray(z).reshape(-1)
    out = np.zeros(sm.index.nblks + 1, dtype=np.float64)
    np.add.at(out, bid.reshape(-1) + 1, zh)
    return out[1:].astype(np.float32)


def sharded_filter(sm: ShardedMatrix, eps: Optional[float]) -> ShardedMatrix:
    """Drop blocks with Frobenius norm < eps (``dbcsr_filter``): norms from
    the sharded store, survivor index on host, owner-local regather +
    survivor mask — the data never leaves its owners."""
    if sm.nblks == 0 or eps is None:
        return sm
    if sm.is_complex_emulated:
        return _emu_s_filter(sm, eps)
    with timed("sharded_filter"):
        nsq = sharded_block_norms(sm).astype(np.float64)
        keep = nsq >= float(eps) ** 2
        if keep.all():
            return sm
        new_index, _ = build_index(
            sm.index.blk_rows[keep], sm.index.col_idx[keep],
            sm.index.row_block_sizes, sm.index.col_block_sizes,
        )
        new_sl = shard_layout(new_index, sm.tile, sm.dist)
        tbl = _put_dev(
            sm.mesh,
            _remap_table(new_index, new_sl, sm.index, sm.shard, sm.tile),
        )
        out = ShardedMatrix(
            name=sm.name, index=new_index, tile=sm.tile, dist=sm.dist,
            shard=new_sl, data=sm.data, sym=sm.sym,
        )
        vm = _sharded_valid_mask(out)

        def local(x, ix, m):
            return (_local_take(x[0], ix[0]) * m[0].astype(x.dtype))[None]

        data = jax.shard_map(
            local, mesh=sm.mesh, in_specs=(_DEV, _DEV, _DEV), out_specs=_DEV
        )(sm.data, tbl, vm)
        return out.with_data(data)


# ---------------------------------------------------------------------------
# split-complex emulation on sharded stores (see ops/complex_emu.py for the
# local twin; same composition from real ops)
# ---------------------------------------------------------------------------

def _emu_s_parts(sm: ShardedMatrix, cdtype):
    """(re, im) real sharded matrices; real operands are lifted with a
    zero imaginary part."""
    if sm.is_complex_emulated:
        return sm.parts()
    zero = replace(
        sm, data=jnp.zeros_like(sm.data), data_im=None, cdtype=None,
        name=f"{sm.name}.im",
    )
    return sm, zero


def _emu_s_add(alpha, a: ShardedMatrix, beta, b: ShardedMatrix) -> ShardedMatrix:
    cdtype = np.promote_types(a.dtype, b.dtype)
    ar, ai = _emu_s_parts(a, cdtype)
    br, bi = _emu_s_parts(b, cdtype)
    alpha, beta = complex(alpha), complex(beta)
    a2r = sharded_add(alpha.real, ar, -alpha.imag, ai)
    a2i = sharded_add(alpha.imag, ar, alpha.real, ai)
    b2r = sharded_add(beta.real, br, -beta.imag, bi)
    b2i = sharded_add(beta.imag, br, beta.real, bi)
    rr = sharded_add(1.0, a2r, 1.0, b2r)
    ii = sharded_add(1.0, a2i, 1.0, b2i)
    return ShardedMatrix.combine(rr, ii, cdtype, name=a.name)


def _emu_s_hadamard(a: ShardedMatrix, b: ShardedMatrix) -> ShardedMatrix:
    cdtype = np.promote_types(a.dtype, b.dtype)
    ar, ai = _emu_s_parts(a, cdtype)
    br, bi = _emu_s_parts(b, cdtype)
    rr = sharded_add(
        1.0, sharded_hadamard(ar, br), -1.0, sharded_hadamard(ai, bi)
    )
    ii = sharded_add(
        1.0, sharded_hadamard(ar, bi), 1.0, sharded_hadamard(ai, br)
    )
    return ShardedMatrix.combine(rr, ii, cdtype, name=a.name)


def _emu_s_filter(sm: ShardedMatrix, eps: float) -> ShardedMatrix:
    """Combined complex block norms decide; both parts keep/drop the same
    blocks (pattern parity with a native complex run)."""
    nsq = sharded_block_norms(sm).astype(np.float64)  # emu-aware
    keep = nsq >= float(eps) ** 2
    if keep.all():
        return sm
    re, im = sm.parts()
    # regather both parts through the same survivor layout
    new_index, _ = build_index(
        sm.index.blk_rows[keep], sm.index.col_idx[keep],
        sm.index.row_block_sizes, sm.index.col_block_sizes,
    )
    new_sl = shard_layout(new_index, sm.tile, sm.dist)
    tbl = _put_dev(
        sm.mesh, _remap_table(new_index, new_sl, sm.index, sm.shard, sm.tile)
    )
    vm_sh = _shard_valid_mask_for(new_index, new_sl, sm.tile, sm.mesh)

    def local(x, ix, vm):
        return (_local_take(x[0], ix[0]) * vm[0])[None]

    smapped = jax.shard_map(
        local, mesh=sm.mesh, in_specs=(_DEV, _DEV, _DEV), out_specs=_DEV
    )
    rr = ShardedMatrix(
        name=sm.name, index=new_index, tile=sm.tile, dist=sm.dist,
        shard=new_sl, data=smapped(re.data, tbl, vm_sh), sym=sm.sym,
    )
    ii = replace(rr, data=smapped(im.data, tbl, vm_sh), name=f"{sm.name}.im")
    return ShardedMatrix.combine(rr, ii, sm.dtype, name=sm.name)


def _shard_valid_mask_for(index, sl, tile, mesh):
    """Survivor validity mask in sharded position order."""
    vm = np.asarray(valid_mask(index, tile))
    out = np.zeros((sl.ndev * sl.n_max,) + vm.shape[1:], dtype=vm.dtype)
    pos_valid = sl.slot_of_pos >= 0
    out[pos_valid] = vm[sl.slot_of_pos[pos_valid]]
    from .sharded import put_global

    return put_global(
        jnp.asarray(out.reshape((sl.ndev, sl.n_max) + vm.shape[1:])),
        mesh_sharding(mesh),
    )


def _emu_s_multiply(
    transa, transb, alpha, a: ShardedMatrix, b: ShardedMatrix, beta, c
) -> ShardedMatrix:
    """4 real sharded products + aligned adds (ops/complex_emu twin)."""
    cdtype = np.promote_types(a.dtype, b.dtype)
    ta = transa.upper()
    tb = transb.upper()
    sa = -1.0 if ta == "C" else 1.0
    sb = -1.0 if tb == "C" else 1.0
    ta_r = "T" if ta in ("T", "C") else "N"
    tb_r = "T" if tb in ("T", "C") else "N"
    ar, ai = _emu_s_parts(a, cdtype)
    br, bi = _emu_s_parts(b, cdtype)
    m_rr = sharded_multiply(ta_r, tb_r, 1.0, ar, br)
    m_ii = sharded_multiply(ta_r, tb_r, 1.0, ai, bi)
    m_ir = sharded_multiply(ta_r, tb_r, 1.0, ai, br)
    m_ri = sharded_multiply(ta_r, tb_r, 1.0, ar, bi)
    prod_re = sharded_add(1.0, m_rr, -sa * sb, m_ii)
    prod_im = sharded_add(sa, m_ir, sb, m_ri)
    alpha = complex(alpha)
    out_re = sharded_add(alpha.real, prod_re, -alpha.imag, prod_im)
    out_im = sharded_add(alpha.imag, prod_re, alpha.real, prod_im)
    out = ShardedMatrix.combine(out_re, out_im, cdtype, name="product")
    if c is not None:
        out = _emu_s_add(1.0, out, complex(beta), c)
    return out
