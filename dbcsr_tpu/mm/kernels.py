"""Tile-stack batched GEMM kernels — this library's libsmm_acc.

The reference JIT-compiles per-(m,n,k) CUDA kernels that process "parameter
stacks" of small GEMMs with atomicAdd into C
(``src/acc/libsmm_acc/libsmm_acc.cpp``, kernels
``smm_acc_dnt_{tiny,small,medium,largeDB*}.h``). Here the stack entries are
(c_tile, a_tile, b_tile) triples over T×T hardware tiles, the stack is
**sorted by output tile** on the host, and every C tile is accumulated by
one owner — deterministic, no atomics (SURVEY.md §7 "scatter-add
contention").

Two implementations with identical semantics:
- ``tile_stack_matmul_xla``: gather → batched matmul → segment-sum. Works
  on any backend and dtype; it is the reference every kernel is checked
  against.
- ``tile_stack_matmul_crun``: the "C-run" kernel, Pallas through Triton.
  One program per (C tile, BM×BN sub-block) walks that tile's sorted run
  of (A, B) pairs, loops along K inside the program, accumulates in f32
  registers and writes its C sub-block once. The XLA form materializes
  the gathered A and B stacks and the per-entry products in device
  memory; this kernel reads each operand slab straight from the tile
  stores and never writes an intermediate.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = [
    "crun_supported",
    "run_pointers",
    "tile_stack_matmul_crun",
    "tile_stack_matmul_xla",
]

_PRECISIONS = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}


@partial(jax.jit, static_argnames=("n_c_tiles", "acc_dtype", "precision"))
def tile_stack_matmul_xla(
    a_tiles: jax.Array,  # [nA, T, T]
    b_tiles: jax.Array,  # [nB, T, T]
    stack: jax.Array,  # [S, 3] int32 (c, a, b), sorted by c
    *,
    n_c_tiles: int,
    acc_dtype=jnp.float32,
    precision: str = "default",
) -> jax.Array:
    """Reference implementation: gather, batched matmul, segment-sum."""
    acc = jnp.promote_types(acc_dtype, a_tiles.dtype)
    ga = jnp.take(a_tiles, stack[:, 1], axis=0)
    gb = jnp.take(b_tiles, stack[:, 2], axis=0)
    prods = jax.lax.dot_general(
        ga,
        gb,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=acc,
        precision=_PRECISIONS[precision],
    )
    out = jax.ops.segment_sum(prods, stack[:, 0], num_segments=n_c_tiles + 1)
    return out[:n_c_tiles].astype(a_tiles.dtype)


def crun_supported(dtype, tile: int, precision: str) -> bool:
    """Whether the C-run kernel can take tiles of this dtype and edge at
    this matmul precision.

    Triton wants power-of-two blocks and a dot whose every dimension is at
    least 16; its dot accumulates in f32, so f64 and complex stay on XLA.
    The kernel's dot is IEEE f32 at "highest" and TF32 at "default";
    "high" has no such match and stays on XLA."""
    return (
        jnp.dtype(dtype) in (jnp.dtype(jnp.float32), jnp.dtype(jnp.bfloat16))
        and tile >= 16
        and tile & (tile - 1) == 0
        and precision in CRUN_LAUNCH
    )


def run_pointers(c_col: np.ndarray, n_c_tiles: int) -> np.ndarray:
    """``run_ptr[n_c+1]``: the c-sorted stack's entries for C tile ``c`` are
    ``run_ptr[c]:run_ptr[c+1]`` (an empty run is a zero tile)."""
    return np.searchsorted(
        np.asarray(c_col), np.arange(n_c_tiles + 1), side="left"
    ).astype(np.int32)


def _crun_kernel(run_ref, a_idx_ref, b_idx_ref, a_ref, b_ref, out_ref, *,
                 bm, bn, bk, tile, precision):
    c = pl.program_id(0)
    i = pl.program_id(1)
    j = pl.program_id(2)
    lo = run_ref[c]
    hi = run_ref[c + 1]
    rows = pl.ds(pl.multiple_of(i * bm, bm), bm)
    cols = pl.ds(pl.multiple_of(j * bn, bn), bn)

    def entry(e, acc):
        ai = a_idx_ref[e]
        bi = b_idx_ref[e]
        for k0 in range(0, tile, bk):
            a = a_ref[ai, rows, pl.ds(k0, bk)]
            b = b_ref[bi, pl.ds(k0, bk), cols]
            acc += jax.lax.dot_general(
                a, b, (((1,), (0,)), ((), ())),
                precision=precision, preferred_element_type=jnp.float32,
            )
        return acc

    acc = jax.lax.fori_loop(lo, hi, entry, jnp.zeros((bm, bn), jnp.float32))
    out_ref[...] = acc.astype(out_ref.dtype)


#: launch shape of the C-run kernel per dot precision: output sub-block,
#: K step, warps and pipeline stages. Swept on an H100 (700 W) over six
#: shapes on the banded and mixed stacks: true-f32 dots run on the FMA
#: units and prefer the smaller sub-block, TF32/bf16 tensor-core dots the
#: taller one (PERF.md, "C-run kernel").
CRUN_LAUNCH = {
    "highest": {"bm": 64, "bn": 64, "bk": 32, "num_warps": 4, "num_stages": 3},
    "default": {"bm": 128, "bn": 64, "bk": 32, "num_warps": 4, "num_stages": 3},
}


@partial(
    jax.jit,
    static_argnames=(
        "n_c_tiles", "precision", "out_dtype", "interpret", "bm", "bn", "bk",
        "num_warps", "num_stages",
    ),
)
def _crun_launch(a_tiles, b_tiles, run_ptr, a_idx, b_idx, *, n_c_tiles,
                 precision, out_dtype, interpret, bm, bn, bk, num_warps,
                 num_stages):
    tile = a_tiles.shape[1]
    bm, bn, bk = min(bm, tile), min(bn, tile), min(bk, tile)
    kernel = partial(
        _crun_kernel, bm=bm, bn=bn, bk=bk, tile=tile,
        precision=_PRECISIONS[precision],
    )
    s = a_idx.shape[0]
    return pl.pallas_call(
        kernel,
        grid=(n_c_tiles, tile // bm, tile // bn),
        out_specs=pl.BlockSpec((None, bm, bn), lambda c, i, j: (c, i, j)),
        out_shape=jax.ShapeDtypeStruct((n_c_tiles, tile, tile), out_dtype),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        interpret=interpret,
        cost_estimate=pl.CostEstimate(
            flops=2 * s * tile**3,
            bytes_accessed=(2 * s + n_c_tiles) * tile * tile
            * a_tiles.dtype.itemsize,
            transcendentals=0,
        ),
        name="crun_stack_matmul",
    )(run_ptr, a_idx, b_idx, a_tiles, b_tiles)


def tile_stack_matmul_crun(
    a_tiles: jax.Array,
    b_tiles: jax.Array,
    stack_np: np.ndarray,  # host int32 [S, 3], sorted by c
    *,
    n_c_tiles: int,
    precision: str = "highest",
    out_dtype=None,
    interpret: bool = False,
) -> jax.Array:
    """C-run stack product (module docstring); same contract as
    :func:`tile_stack_matmul_xla`, launched with the precision's
    ``CRUN_LAUNCH`` shape."""
    tile = a_tiles.shape[1]
    out_dtype = out_dtype or a_tiles.dtype
    if len(stack_np) == 0 or n_c_tiles == 0:
        return jnp.zeros((n_c_tiles, tile, tile), dtype=out_dtype)
    stack_np = np.asarray(stack_np, dtype=np.int32)
    return _crun_launch(
        a_tiles, b_tiles,
        jnp.asarray(run_pointers(stack_np[:, 0], n_c_tiles)),
        jnp.asarray(stack_np[:, 1]), jnp.asarray(stack_np[:, 2]),
        n_c_tiles=n_c_tiles, precision=precision,
        out_dtype=jnp.dtype(out_dtype), interpret=interpret,
        **CRUN_LAUNCH[precision],
    )
