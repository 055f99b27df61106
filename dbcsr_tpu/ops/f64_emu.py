"""True-f64 matmul via error-free bf16 slicing (Ozaki scheme).

For devices whose f64 rate is far below their bf16 rate, this module
multiplies f64 operands with bf16 matrix products, every intermediate
EXACT until one final f64 combine. The engine uses it only on request
(``f64_method="ozaki"``): the H100's FP64 tensor cores run the native
dot, and the slice scheme's stack product needs many times the memory
(PERF.md). The steps:

1. **scale** — each row of A (column of B) is scaled per 128-wide
   K-chunk by a power of two so values sit in [-1, 1] (powers of two
   multiply exactly in f64);
2. **slice** — the scaled value is split into S slices of 8 mantissa
   bits each, round-to-nearest on the absolute grid ``2^-8(k+1)``.
   Every slice is an integer multiple of its grid step with <= 8
   significant bits, hence exactly representable in bfloat16;
3. **multiply** — slice pairs (i, j) with ``i + j < S`` run as native
   ``bf16 x bf16 -> f32`` dots over K = 128. Each scalar product is
   an integer multiple of a common power-of-two grid bounded by 2^16
   grid units, so a 128-term f32 accumulation stays below 2^24 grid
   units and is EXACT (f32 carries 24 mantissa bits);
4. **combine** — the <= S(S+1)/2 pair products are summed, row/column
   scales reapplied, and K-chunks accumulated in f64 (one fused
   elementwise pass per chunk). The only roundings in the pipeline are
   this f64 combine and the dropped slice pairs with ``i + j >= S``.

Worst-case relative error ~ ``S * 2^(-8S) * kappa + O(n_chunks * 2^-53)``
where kappa = sum|a||b| / |sum a b| is the usual inner-product condition
number; at the default S = 7 the dropped-pair term (~2^-53 relative) is
comparable to — and for long contractions better than — a sequentially
accumulated native f64 GEMM.

Reference analog: fp64 is the reference GPU backend's PRIMARY type
(``src/acc/libsmm_acc/libsmm_acc.cpp:92-150``,
``parameters/parameters_*.json`` tune double kernels). This scheme gives
the same dtype semantics from exact fixed-point slices on a bf16 matrix
unit.

NaN/Inf caveat: non-finite inputs do not propagate IEEE-correctly
through the slicing (the scale of a non-finite row is clamped); the
engine only routes finite block data here (matching the reference,
whose GPU stacks assume finite panels).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "DEFAULT_SLICES",
    "DEFAULT_STACK_SLICES",
    "ozaki_slices",
    "ozaki_matmul",
    "tile_stack_matmul_ozaki",
]

#: 7 slices x 8 bits cover the 53-bit f64 mantissa to ~2^-53 relative
#: worst case once the (i + j >= S) cross terms are dropped.
DEFAULT_SLICES = 7

#: the STACK path slices 7 bits x 8 slices instead: with b-bit slices a
#: whole anti-diagonal pair group (i + j = d, d+1 <= S pairs, K <= 128)
#: is a sum of <= 2^(2b) * 2^7 * S grid units — at b=7, S=8 that is
#: exactly 2^24, the f32 exact-integer bound, so per-diagonal grouping
#: accumulates EXACTLY in f32 and only S (not S(S+1)/2) f64 adds remain
#: per stack entry. 8 x 7 = 56 bits >= the 53-bit f64 mantissa.
DEFAULT_STACK_SLICES = 8
_STACK_BITS = 7


def _pow2_scale(x: jax.Array, axis: int) -> jax.Array:
    """Per-vector power-of-two scale along ``axis``: smallest 2^e with
    max|x| <= 2^e (and 1.0 for all-zero / non-finite-free rows).
    Powers of two, so dividing by it is EXACT in f64."""
    m = jnp.max(jnp.abs(x), axis=axis, keepdims=True)
    m = jnp.where(jnp.isfinite(m) & (m > 0), m, 1.0)
    # exact for exact powers of two: log2 of 2^k is integral, ceil keeps it
    e = jnp.ceil(jnp.log2(m))
    s = jnp.exp2(e)
    # guard log2 rounding down (e.g. m slightly above 2^k): bump once
    s = jnp.where(s < m, s * 2.0, s)
    return s


def ozaki_slices(y: jax.Array, n_slices: int) -> list:
    """Split ``y`` (f64, |y| <= 1) into ``n_slices`` bf16 slices on the
    absolute grids ``2^-8(k+1)``. The k-th slice is an integer multiple
    of its grid step bounded by 2^8 grid units; the running remainder is
    exact in f64 (both operands are multiples of ulp(y))."""
    slices = []
    r = y
    for k in range(n_slices):
        step = np.float64(2.0 ** (-8 * (k + 1)))
        s = jnp.round(r * (1.0 / step)) * step
        slices.append(s.astype(jnp.bfloat16))
        if k + 1 < n_slices:
            r = r - s
    return slices


def _pair_products(a_sl, b_sl, n_slices, dims):
    """All exact f32 pair dots with i + j < S, summed in f64."""
    acc = None
    for i in range(n_slices):
        for j in range(n_slices - i):
            p = jax.lax.dot_general(
                a_sl[i], b_sl[j], dimension_numbers=dims,
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.DEFAULT,
            ).astype(jnp.float64)
            acc = p if acc is None else acc + p
    return acc


@partial(jax.jit, static_argnames=("n_slices", "k_chunk"))
def ozaki_matmul(
    a: jax.Array,  # [..., M, K] float64
    b: jax.Array,  # [..., K, N] float64 (batch dims must match a's)
    n_slices: int = DEFAULT_SLICES,
    k_chunk: int = 128,
) -> jax.Array:
    """f64 ``a @ b`` (with matching leading batch dims) via exact bf16
    slice products. K is processed in ``k_chunk``-wide pieces so the f32
    accumulations stay exact (``16 + log2(k_chunk) < 24``); chunk results
    accumulate in f64."""
    if k_chunk > 128:
        raise ValueError("k_chunk > 128 breaks the exact-f32 bound")
    if not n_slices:  # 0/None = this path's full-f64 default
        n_slices = DEFAULT_SLICES
    a = jnp.asarray(a, jnp.float64)
    b = jnp.asarray(b, jnp.float64)
    *batch, m, k = a.shape
    kb, n = b.shape[-2], b.shape[-1]
    if kb != k or tuple(b.shape[:-2]) != tuple(batch):
        raise ValueError(f"shape mismatch {a.shape} x {b.shape}")
    nb = len(batch)
    pad = (-k) % k_chunk
    if pad:
        a = jnp.pad(a, [(0, 0)] * nb + [(0, 0), (0, pad)])
        b = jnp.pad(b, [(0, 0)] * nb + [(0, pad), (0, 0)])
    n_chunks = (k + pad) // k_chunk
    dims = (((nb + 1,), (nb,)), (tuple(range(nb)), tuple(range(nb))))

    def one_chunk(c):
        ac = jax.lax.dynamic_slice_in_dim(a, c * k_chunk, k_chunk, nb + 1)
        bc = jax.lax.dynamic_slice_in_dim(b, c * k_chunk, k_chunk, nb)
        sa = _pow2_scale(ac, axis=nb + 1)  # [..., M, 1]
        sb = _pow2_scale(bc, axis=nb)      # [..., 1, N]
        a_sl = ozaki_slices(ac / sa, n_slices)
        b_sl = ozaki_slices(bc / sb, n_slices)
        ps = _pair_products(a_sl, b_sl, n_slices, dims)
        return ps * (sa * sb)  # power-of-two unscale: exact

    if n_chunks == 1:
        return one_chunk(0)

    def body(carry, c):
        return carry + one_chunk(c), None

    init = jnp.zeros((*batch, m, n), jnp.float64)
    out, _ = jax.lax.scan(body, init, jnp.arange(n_chunks))
    return out


def _slice_tiles(
    tiles: jax.Array, n_slices: int, bits: int, axis: int
):
    """Per-tile-vector power-of-two scale + ``bits``-bit bf16 slices of a
    whole TILE STORE. Slicing once per stored tile (instead of once per
    gathered stack entry, as ``ozaki_matmul`` does) amortizes the
    emulated-f64 elementwise work over every reuse of the tile in the
    stack — on banded patterns each tile feeds ~band-width entries, so
    this is the difference between slicing nA tiles and slicing S stack
    entries (measured the dominant cost of the round-4 stack path)."""
    s = _pow2_scale(tiles, axis=axis)
    y = tiles / s  # exact: power-of-two divide
    slices = []
    r = y
    for k in range(n_slices):
        step = np.float64(2.0 ** (-bits * (k + 1)))
        v = jnp.round(r * (1.0 / step)) * step
        slices.append(v.astype(jnp.bfloat16))
        if k + 1 < n_slices:
            r = r - v
    return s, slices


_STACK_DIMS = (((2,), (1,)), ((0,), (0,)))


def tile_stack_matmul_ozaki(
    a_tiles: jax.Array,  # [nA, T, T] float64
    b_tiles: jax.Array,  # [nB, T, T] float64
    stack: jax.Array,  # [S, 3] int32 (c, a, b), sorted by c
    *,
    n_c_tiles: int,
    n_slices: int | None = None,
) -> jax.Array:
    """f64 twin of ``mm.kernels.tile_stack_matmul_xla`` via exact bf16
    slice products, restructured for throughput (round-5):

    - stores are scaled + sliced ONCE (``_slice_tiles``), per tile row
      of A / tile column of B — numerically identical to the per-chunk
      scaling of ``ozaki_matmul`` since a tile IS one K-chunk;
    - slice gathers are tile-level bf16 takes (HBM-bandwidth);
    - the kept pair products (i + j < S) run as batched bf16 dots
      and accumulate PER ANTI-DIAGONAL in f32 — exact, because 7-bit
      slices bound a whole diagonal group by 2^24 grid units (see
      ``DEFAULT_STACK_SLICES``);
    - only S f64 adds + one f64 unscale survive per entry, then the
      f64 segment-sum into C tiles.

    Worst-case relative error ~``S(S+1)/2 * 2^(-7S)`` x the inner-
    product condition number + the f64 segment-sum rounding — at the
    default S=8 (56 mantissa bits) comparable to a sequentially
    accumulated native f64 GEMM, same guarantee class as before.
    """
    if not n_slices:
        n_slices = DEFAULT_STACK_SLICES
    t = a_tiles.shape[-1]
    if t > 128:
        raise ValueError("tile > 128 breaks the exact-f32 bound")
    return _tile_stack_ozaki_impl(
        a_tiles, b_tiles, stack, n_c_tiles=n_c_tiles, n_slices=n_slices
    )


@partial(jax.jit, static_argnames=("n_c_tiles", "n_slices"))
def _tile_stack_ozaki_impl(a_tiles, b_tiles, stack, *, n_c_tiles, n_slices):
    sa, a_sl = _slice_tiles(
        jnp.asarray(a_tiles, jnp.float64), n_slices, _STACK_BITS, axis=-1
    )
    sb, b_sl = _slice_tiles(
        jnp.asarray(b_tiles, jnp.float64), n_slices, _STACK_BITS, axis=-2
    )
    ia, ib, ic = stack[:, 1], stack[:, 2], stack[:, 0]
    ga = [jnp.take(s, ia, axis=0) for s in a_sl]
    gb = [jnp.take(s, ib, axis=0) for s in b_sl]
    acc = None
    for d in range(n_slices):
        pd = None  # anti-diagonal i + j = d: EXACT f32 accumulation
        for i in range(d + 1):
            q = jax.lax.dot_general(
                ga[i], gb[d - i], dimension_numbers=_STACK_DIMS,
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.DEFAULT,
            )
            pd = q if pd is None else pd + q
        p64 = pd.astype(jnp.float64)
        acc = p64 if acc is None else acc + p64
    prods = acc * (jnp.take(sa, ia, axis=0) * jnp.take(sb, ib, axis=0))
    out = jax.ops.segment_sum(prods, ic, num_segments=n_c_tiles + 1)
    return out[:n_c_tiles]
