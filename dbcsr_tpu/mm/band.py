"""Band-diagonal (tile-DIA) multiply driver.

Banded block patterns — the linear-scaling SCF shape DBCSR exists for —
defeat both other drivers: the dense path pays the full Mt·Kt·Nt tile
cube, and the stack path pays a per-entry cost on every tile triple. The
band driver is neither: store the band as TILE DIAGONALS ``[W, Mt, T, T]``
and compute the product as the W_a·W_b diagonal convolution

    C[d1+d2, m] += A[d1, m] @ B[d2, m + off_a + d1]

— a statically-unrolled family of plain BATCHED matmuls over shifted
views, which XLA hands to the GEMM library with no per-tile overhead.
The shifted access is a static slice of a zero-padded diagonal array, so
the whole product is one fused jitted expression.

Hardware flops grow from 2·S·T³ (stack) to 2·W_a·W_b·Mt·T³ (every
diagonal cell, present or not), but each flop runs at dense batched-GEMM
speed; the auto heuristic admits the band driver only when the padded
work stays within ``band_flop_factor`` of the stack work.

Reference analog: there is none — the reference's accdrv treats banded
stacks like any other (``dbcsr_mm_accdrv.F``); this driver trades padded
flops for wide batched GEMMs, which matrix units run far faster per flop
than many small products.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["BandPlan", "plan_band", "band_matmul"]

_PRECISIONS = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}


@dataclass
class BandPlan:
    """Static description of one band multiply C = A·B over tile stores."""

    a_pack: np.ndarray  # int [Wa*Mt] -> a store slot (-1 = absent)
    b_pack: np.ndarray  # int [Wb*Kt]
    c_unpack: np.ndarray  # int [n_c_tiles] -> position in [Wc*Mt]
    wa: int
    wb: int
    off_a: int  # smallest tile-diagonal offset of A (c - r)
    off_b: int
    mt: int
    kt: int
    hw_flops: float


def _diag_extent(coords: np.ndarray) -> Tuple[int, int]:
    d = coords[:, 1].astype(np.int64) - coords[:, 0].astype(np.int64)
    return int(d.min()), int(d.max())


def plan_band(
    a_coords: np.ndarray,
    a_grid: Tuple[int, int],
    b_coords: np.ndarray,
    b_grid: Tuple[int, int],
    c_keys: np.ndarray,  # sorted row-major product tile keys
    *,
    tile: int,
    n_stack: Optional[int] = None,
    max_products: int = 128,
    flop_factor: float = 6.0,
) -> Optional[BandPlan]:
    """Band plan, or None when the pattern is not band-suitable.

    ``n_stack`` (tile-triple count of the stack path) gates admission:
    the padded band work ``wa*wb*mt`` must stay within ``flop_factor``
    of it — batched dense matmuls run that much faster per tile product
    than the stack products.
    """
    mt, kt = a_grid
    kt2, nt = b_grid
    if len(a_coords) == 0 or len(b_coords) == 0:
        return None
    lo_a, hi_a = _diag_extent(a_coords)
    lo_b, hi_b = _diag_extent(b_coords)
    wa = hi_a - lo_a + 1
    wb = hi_b - lo_b + 1
    if wa * wb > max_products:
        return None
    if n_stack is not None and wa * wb * mt > flop_factor * max(n_stack, 1):
        return None

    def pack(coords, lo, w, nrows, ncols_grid):
        out = np.full(w * nrows, -1, dtype=np.int64)
        r = coords[:, 0].astype(np.int64)
        d = coords[:, 1].astype(np.int64) - r - lo
        out[d * nrows + r] = np.arange(len(coords), dtype=np.int64)
        return out

    a_pack = pack(a_coords, lo_a, wa, mt, kt)
    b_pack = pack(b_coords, lo_b, wb, kt, nt)

    wc = wa + wb - 1
    off_c = lo_a + lo_b
    c_r = (c_keys // nt).astype(np.int64)
    c_c = (c_keys % nt).astype(np.int64)
    dc = c_c - c_r - off_c
    if len(dc) and (dc.min() < 0 or dc.max() >= wc):
        return None  # product keys outside the band (shouldn't happen)
    c_unpack = dc * mt + c_r

    return BandPlan(
        a_pack=a_pack, b_pack=b_pack, c_unpack=c_unpack,
        wa=wa, wb=wb, off_a=lo_a, off_b=lo_b, mt=mt, kt=kt,
        hw_flops=2.0 * wa * wb * mt * tile**3,
    )


@partial(
    jax.jit,
    static_argnames=("wa", "wb", "off_a", "mt", "kt", "tile", "prec"),
)
def _band_product(
    a_band,  # [Wa, Mt, T, T]
    b_band,  # [Wb, Kt, T, T]
    *,
    wa: int,
    wb: int,
    off_a: int,
    mt: int,
    kt: int,
    tile: int,
    prec: str,
):
    """The diagonal convolution as Wa batched WIDE matmuls.

    A batched [T,T]@[T,T] product leaves the matrix unit short of work
    (no N amortization per batch element). Lifting all of B's diagonals of
    one row into the N axis — ``B_rows[k] = [T, Wb*T]`` — turns the inner
    d2 loop into matmul WIDTH: per d1 one batched
    ``[Mt, T, T] @ [Mt, T, Wb*T]`` product whose [T, Wb, T] output slices
    accumulate into the shifted output diagonals. Output [Wc, Mt, T, T]
    in f32 accumulation."""
    precision = _PRECISIONS[prec]
    acc_t = jnp.promote_types(jnp.float32, a_band.dtype)
    wc = wa + wb - 1
    # B rows in wide form [Kt, T, Wb*T]
    b_rows = jnp.transpose(b_band, (1, 2, 0, 3)).reshape(
        kt, tile, wb * tile
    )
    # pad the row axis so every shifted slice is static and in range:
    # k = m + off_a + d1 for m in [0, Mt), d1 in [0, Wa)
    pad_lo = max(0, -off_a)
    pad_hi = max(0, (mt - 1) + off_a + (wa - 1) - (kt - 1))
    b_pad = jnp.pad(b_rows, ((pad_lo, pad_hi), (0, 0), (0, 0)))
    out = [None] * wc
    for d1 in range(wa):
        start = off_a + d1 + pad_lo  # >= 0 by construction
        b_shift = jax.lax.dynamic_slice_in_dim(b_pad, start, mt, axis=0)
        prod = jax.lax.dot_general(
            a_band[d1],
            b_shift,
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=acc_t,
            precision=precision,
        ).reshape(mt, tile, wb, tile)
        for d2 in range(wb):
            dc = d1 + d2
            contrib = prod[:, :, d2, :]
            out[dc] = contrib if out[dc] is None else out[dc] + contrib
    return jnp.stack(out).astype(a_band.dtype)


def band_matmul(
    a_tiles: jax.Array,
    b_tiles: jax.Array,
    plan: BandPlan,
    *,
    tile: int,
    precision: str = "highest",
) -> jax.Array:
    """Run the band product; returns C tiles in ``plan.c_unpack`` order
    (the product-key order the engine aligns from)."""
    from ..block.tileops import take_tiles

    a_band = take_tiles(a_tiles, plan.a_pack, tile).reshape(
        plan.wa, plan.mt, tile, tile
    )
    b_band = take_tiles(b_tiles, plan.b_pack, tile).reshape(
        plan.wb, plan.kt, tile, tile
    )
    c_band = _band_product(
        a_band, b_band, wa=plan.wa, wb=plan.wb, off_a=plan.off_a,
        mt=plan.mt, kt=plan.kt, tile=tile, prec=precision,
    )
    flat = c_band.reshape(-1, tile, tile)
    return jnp.take(flat, jnp.asarray(plan.c_unpack), axis=0)
