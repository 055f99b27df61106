"""Per-block norms and matrix-level norms.

Analog of the reference's norms machinery: per-block squared Frobenius norms
feed epsilon filtering (``src/mm/dbcsr_mm_common.F:629-694``, GPU variant
``calculate_norms.cpp``); matrix norms frobenius / maxabs / gershgorin
mirror ``dbcsr_types.F:231-234`` + ``src/ops/dbcsr_operations.F``.

Per-block sums on a tile store run as two small per-tile INDICATOR matmuls
(``block/tileops.py``) — matrix-unit work, no scatters (scatters/segment-sums
at element granularity are far slower, see store.py).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..block.bcsr import BCSRMatrix, SYM_NONE
from ..block.tileops import block_sums_sq

__all__ = [
    "block_norms_sq",
    "block_norms",
    "norm_frobenius",
    "norm_maxabs",
    "norm_gershgorin",
    "norm_column",
]


def block_norms_sq(m: BCSRMatrix) -> np.ndarray:
    """Squared Frobenius norm per stored block, float32 host [nblks]
    (single-precision norms like the reference,
    ``src/mm/dbcsr_mm_common.F:629``).

    Memoized per matrix object against its (immutable) tile store: a
    filtered multiply reads operand norms every call and the final
    filter re-reads the product's — identical data must not pay the
    device reduction + transfer twice. The result is marked read-only
    because it is shared across callers."""
    if m.is_complex_emulated:
        from .complex_emu import emu_block_norms_sq

        return emu_block_norms_sq(m)
    memo = getattr(m, "_norms_sq_memo", None)
    if memo is not None and memo[0] is m.data:
        return memo[1]
    out = block_sums_sq(m.index, m.tile, m.data)
    out = np.asarray(out)
    out.flags.writeable = False
    object.__setattr__(m, "_norms_sq_memo", (m.data, out))
    return out


def block_norms(m: BCSRMatrix) -> np.ndarray:
    return np.sqrt(block_norms_sq(m).astype(np.float64)).astype(np.float32)


def norm_frobenius(m: BCSRMatrix) -> float:
    if m.is_complex_emulated:
        re, im = m.parts()
        return float(np.hypot(norm_frobenius(re), norm_frobenius(im)))
    if m.sym != SYM_NONE:
        # Off-diagonal stored blocks count twice. Diagonal blocks follow
        # desymmetrize's shadowing convention (transform.py): the strictly-
        # lower interior is replaced by the reflected upper triangle, so it
        # contributes 2*||triu(b,1)||^2 + ||diag(b)||^2 — stored strictly-
        # lower elements of diagonal blocks are ignored. This keeps
        # norm_frobenius(m) == norm_frobenius(desymmetrize(m)) even when a
        # stored diagonal block is not internally symmetric.
        nsq = block_norms_sq(m).astype(np.float64)
        diag = m.index.blk_rows == m.index.col_idx
        off_sum = nsq[~diag].sum()
        idx = m.index
        diag_ids = np.flatnonzero(diag)
        diag_sum = 0.0
        if len(diag_ids):
            host = m.flat_host()
            _, bn = idx.blk_shapes
            spans = np.concatenate(
                [
                    np.arange(idx.blk_offset[b], idx.blk_offset[b + 1])
                    for b in diag_ids
                ]
            )
            b_of = idx.elem_to_blk[spans]
            off_in_blk = spans - idx.blk_offset[b_of]
            ncols = bn[b_of].astype(np.int64)
            r_loc = off_in_blk // ncols
            c_loc = off_in_blk % ncols
            w = np.where(r_loc < c_loc, 2.0, np.where(r_loc == c_loc, 1.0, 0.0))
            vals = host[spans]
            diag_sum = float(((vals * np.conj(vals)).real.astype(np.float64) * w).sum())
        return float(np.sqrt(2.0 * off_sum + diag_sum))
    if m.data.size == 0:
        return 0.0
    # padding positions are exactly 0, so the raw store sum is the norm
    return float(jnp.sqrt(jnp.sum((m.data * jnp.conj(m.data)).real)))


def norm_maxabs(m: BCSRMatrix) -> float:
    if m.data.size == 0:
        return 0.0
    if m.is_complex_emulated:
        return float(
            jnp.sqrt(jnp.max(m.data * m.data + m.data_im * m.data_im))
        )
    return float(jnp.max(jnp.abs(m.data)))


def norm_column(m: BCSRMatrix) -> float:
    """Matrix 1-norm: max over columns of sum_i |a_ij| (the reference's
    column norm, ``dbcsr_norm_column``); sublane reduction per tile +
    tile-column combine."""
    if m.is_complex_emulated:
        from .transform import desymmetrize as _desym

        mm = _desym(m)
        re, im = mm.parts()
        absm = re.with_data(jnp.sqrt(re.data * re.data + im.data * im.data))
        return norm_column(absm)
    mm = m
    if m.sym != SYM_NONE:
        from .transform import desymmetrize

        mm = desymmetrize(m)
    if mm.data.size == 0:
        return 0.0
    lay = mm.layout
    s = jnp.abs(mm.data).sum(axis=1)  # [nt, T] per-tile column sums
    per_col = jnp.zeros((lay.ntc, mm.tile), dtype=s.dtype)
    per_col = per_col.at[jnp.asarray(lay.tile_coords[:, 1])].add(s)
    return float(jnp.max(per_col))


def norm_gershgorin(m: BCSRMatrix) -> float:
    """Gershgorin-circle bound: max over rows of sum_j |a_ij| (on the
    symmetry-expanded matrix). Lane reduction per tile + tile-row combine —
    all at >=128-lane granularity."""
    if m.is_complex_emulated:
        from .transform import desymmetrize as _desym

        mm = _desym(m)
        re, im = mm.parts()
        absm = re.with_data(jnp.sqrt(re.data * re.data + im.data * im.data))
        return norm_gershgorin(absm)
    mm = m
    if m.sym != SYM_NONE:
        from .transform import desymmetrize

        mm = desymmetrize(m)
    if mm.data.size == 0:
        return 0.0
    lay = mm.layout
    s = jnp.abs(mm.data).sum(axis=2)  # [nt, T] per-tile row sums
    per_row = jnp.zeros((lay.ntr, mm.tile), dtype=s.dtype)
    per_row = per_row.at[jnp.asarray(lay.tile_coords[:, 0])].add(s)
    return float(jnp.max(per_row))
