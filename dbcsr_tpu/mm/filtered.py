"""Device-resident epsilon-filtered multiply: the linear-scaling SCF form.

The reference's reason to exist is the eps-filtered multiply inside an
iterative loop: per SCF step it recomputes block norms, applies per-row
thresholds inside the hot tick loop (``src/mm/dbcsr_mm_cannon.F:1042-1113``)
and prunes the product to blocks with Frobenius norm >= eps
(``multrec_filtering``, ``src/mm/dbcsr_mm_multrec.F:390``). Its motivation
is FLOP avoidance; on an accelerator driven from Python the per-call host
bookkeeping (norms to the host, replanning, index builds) costs far more
than the avoided matrix work, so this design inverts it:

* Plan ONCE on the operand *patterns* (the symbolic SUPERSET product,
  no norms): C's superset index, the tile plans, and the
  block<->tile indicator structure. Host work happens only when a
  pattern changes.
* Per call, ONE jitted device step: superset product (the same tuned
  kernels every unfiltered multiply uses) -> per-block Frobenius norms
  as indicator matmuls + a segment-sum -> keep = norms >= eps ->
  elementwise keep-mask zeroing dropped blocks. No host sync, no
  replan, data may change every call.

Numerical equivalence to the engine's host-planned ``filter_mode="sum"``
path (the default): a C block is pre-dropped there iff
``sum_k |A_ik|^2 |B_kj|^2 < (eps/row_nk)^2``; by Cauchy-Schwarz each
norm product is then < eps/row_nk, so ``|C_ij|_F <= sum_k |A_ik||B_kj|
< eps`` — every pre-dropped block is one the mandatory final filter
removes anyway. Computing the superset product and applying only the
final filter therefore yields the same kept set (up to exact-boundary
ties) and bit-identical values on kept blocks, while keeping every
shape static. ``tests/test_filtered_exec.py`` pins the equivalence.

The result stays in MASK form: C's superset index with dropped blocks
zeroed (the store invariant — padding and dropped positions exactly 0 —
is preserved, so the result feeds the next iteration's executor with no
conversion). ``compact()`` materializes the pruned ``BCSRMatrix`` when a
caller wants the reference's compacted form (end of the SCF loop).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..block.bcsr import BCSRMatrix
from ..block.index import BCSRIndex, build_index
from ..block.store import store_layout
from ..block.tileops import take_tiles, tile_align_map, tile_block_info
from ..core.errors import dbcsr_assert

__all__ = ["FilteredExecutor", "build_filtered_executor"]


@partial(jax.jit, static_argnames=("nblks",), donate_argnums=())
def _block_norms_device(c_store, J_dev, I_dev, seg_ids, *, nblks: int):
    """Per-block Frobenius norm² on device: two indicator matmuls per tile
    (``tileops._per_tile_block_sums`` semantics) + a segment-sum joining
    blocks that span several tiles. f32 norms like the reference's
    (``src/acc/cuda_hip/calculate_norms.cpp``)."""
    x2 = (c_store * jnp.conj(c_store)).real.astype(jnp.float32)
    y = jnp.einsum("tia,tij->taj", J_dev, x2,
                   precision=jax.lax.Precision.HIGHEST)
    z = jnp.einsum("taj,tjb->tab", y, I_dev,
                   precision=jax.lax.Precision.HIGHEST)
    sums = jax.ops.segment_sum(
        z.reshape(-1), seg_ids, num_segments=nblks + 1
    )
    return sums[1:]  # segment 0 collects the non-block padding positions


@jax.jit
def _keep_mask(keep_f, bid_p1, K_dev, J_dev, I_dev):
    """[n_tiles, T, T] elementwise mask selecting kept stored blocks:
    ``mask[t,i,j] = sum_ab J[t,i,a] * keep[bid[t,a,b]] * K[t,a,b] * I[t,j,b]``
    — the device twin of ``tileops.block_mask_store`` with the keep vector
    living on device."""
    kf = jnp.concatenate([jnp.zeros((1,), jnp.float32), keep_f])
    Kd = jnp.take(kf, bid_p1, axis=0) * K_dev
    return jnp.einsum("tia,tab,tjb->tij", J_dev, Kd, I_dev)


@dataclass
class FilteredExecutor:
    """Plan-once eps-filtered multiply over fixed operand patterns.

    ``step(a_data, b_data) -> (c_data, keep, norms_sq)`` is pure and
    jittable (it already runs under jit internally; it composes under an
    outer jit/scan too): ``c_data`` is the product in C's SUPERSET store
    layout with blocks of Frobenius norm < eps zeroed out, ``keep`` the
    f32 0/1 vector over superset blocks, ``norms_sq`` the pre-mask block
    norms². ``eff_flops`` counts the superset product (the flops the
    device actually performs, block-granular); ``kept_flops(keep)`` gives
    the filtered-path accounting for comparison with the host planner.
    """

    transa: str
    transb: str
    eps: float
    c_index: BCSRIndex  # superset pattern
    eff_flops: float
    tile: int
    dtype: object
    _fn: object  # plan-once superset executor (engine.build_multiply_executor)
    _J_dev: jax.Array
    _I_dev: jax.Array
    _K_dev: jax.Array
    _bid_p1: jax.Array
    _seg_ids: jax.Array
    _flop_w: np.ndarray  # per-superset-block effective flops (host)

    def step(
        self, a_data: jax.Array, b_data: jax.Array
    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
        c_sup = self._fn(a_data, b_data)
        nblks = self.c_index.nblks
        if nblks == 0:
            return c_sup, jnp.zeros((0,), jnp.float32), jnp.zeros(
                (0,), jnp.float32
            )
        nsq = _block_norms_device(
            c_sup, self._J_dev, self._I_dev, self._seg_ids, nblks=nblks
        )
        keep = (nsq >= jnp.float32(self.eps) ** 2).astype(jnp.float32)
        mask = _keep_mask(
            keep, self._bid_p1, self._K_dev, self._J_dev, self._I_dev
        )
        return c_sup * mask.astype(c_sup.dtype), keep, nsq

    def kept_flops(self, keep) -> float:
        """Effective flops restricted to kept blocks — the number the
        host-planned filtered path reports (flop accounting of
        ``dbcsr_multiply_generic``)."""
        return float(np.asarray(keep, dtype=np.float64) @ self._flop_w)

    def compact(self, c_data: jax.Array, keep) -> BCSRMatrix:
        """Materialize the pruned matrix (the reference's compacted form):
        host index build over kept blocks + tile-level gather. Pay this
        once at the end of an iterative loop, not per step."""
        keep_np = np.asarray(keep) > 0.5
        rows = self.c_index.blk_rows[keep_np]
        cols = self.c_index.col_idx[keep_np]
        new_index, _ = build_index(
            rows.astype(np.int64), cols.astype(np.int64),
            self.c_index.row_block_sizes, self.c_index.col_block_sizes,
        )
        sup_lay = store_layout(self.c_index, self.tile)
        new_lay = store_layout(new_index, self.tile)
        amap = tile_align_map(new_lay.tile_keys(), sup_lay.tile_keys())
        data = take_tiles(c_data, amap, self.tile)
        # dropped blocks sharing tiles with survivors are already zeroed
        # by the step's keep mask — the store invariant holds
        return BCSRMatrix(name="product", index=new_index, data=data)


def build_filtered_executor(
    transa: str,
    transb: str,
    a: BCSRMatrix,
    b: BCSRMatrix,
    eps: float,
    *,
    driver: Optional[str] = None,
) -> FilteredExecutor:
    """Plan the eps-filtered multiply ``C = op(A)·op(B), |C_blk| >= eps``
    for repeated execution with CHANGING data over fixed patterns — the
    analog of the reference's batched-multiply state machine wrapped
    around its filtered multiply (linear-scaling SCF's inner loop).
    """
    from .engine import build_multiply_executor
    from .plan import symbolic_product

    dbcsr_assert(
        not (a.is_complex_emulated or b.is_complex_emulated),
        "filtered executor: split-complex operands not supported "
        "(use dt.multiply(filter_eps=...))",
    )
    dbcsr_assert(eps is not None and float(eps) > 0.0, "eps must be > 0")
    fn, c_index, eff_flops = build_multiply_executor(
        transa, transb, a, b, driver=driver
    )
    tile = a.tile
    info = tile_block_info(c_index, tile)
    nblks = c_index.nblks
    bid_flat = info.bid.reshape(-1).astype(np.int64)
    seg_ids = jnp.asarray((bid_flat + 1).astype(np.int32))
    bid_p1 = jnp.asarray((info.bid + 1).astype(np.int32))

    # per-block effective flops of the superset product (static):
    # flops(i,j) = 2 * m_i * n_j * sum_k k_size over contributing triples
    ta = transa.upper() in ("T", "C")
    tb = transb.upper() in ("T", "C")
    symb = symbolic_product(a.index, ta, b.index, tb)
    m_sizes = c_index.row_block_sizes.astype(np.float64)
    n_sizes = c_index.col_block_sizes.astype(np.float64)
    import scipy.sparse as sp

    k_sizes = (
        a.index.row_block_sizes if ta else a.index.col_block_sizes
    ).astype(np.float64)
    pa = sp.csr_matrix(
        (
            np.ones(a.index.nblks),
            a.index.col_idx.astype(np.int64),
            a.index.row_ptr.astype(np.int64),
        ),
        shape=(a.index.nblkrows, a.index.nblkcols),
    )
    pa = pa.T.tocsr() if ta else pa
    pb = sp.csr_matrix(
        (
            np.ones(b.index.nblks),
            b.index.col_idx.astype(np.int64),
            b.index.row_ptr.astype(np.int64),
        ),
        shape=(b.index.nblkrows, b.index.nblkcols),
    )
    pb = pb.T.tocsr() if tb else pb
    ak = pa.multiply(k_sizes[None, :]).tocsr()
    ksum = (ak @ pb).tocsr()
    rows = c_index.blk_rows.astype(np.int64)
    cols = c_index.col_idx.astype(np.int64)
    ks = np.asarray(ksum[rows, cols]).ravel() if nblks else np.zeros(0)
    flop_w = 2.0 * m_sizes[rows] * n_sizes[cols] * ks

    return FilteredExecutor(
        transa=transa,
        transb=transb,
        eps=float(eps),
        c_index=c_index,
        eff_flops=eff_flops,
        tile=tile,
        dtype=a.dtype,
        _fn=fn,
        _J_dev=info.J_dev,
        _I_dev=info.I_dev,
        _K_dev=jnp.asarray(info.K),
        _bid_p1=bid_p1,
        _seg_ids=seg_ids,
        _flop_w=flop_w,
    )
