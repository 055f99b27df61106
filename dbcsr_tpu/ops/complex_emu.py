"""Split-complex (re/im) emulation of the z/c type classes for backends
whose device toolchain rejects complex arrays (see
``core/machine.backend_supports_complex``; the CPU and GPU backends do
complex natively, so this runs where a caller or test forces it).

The reference instantiates every routine for d/s/z/c via fypp
(``/root/reference/src/data/dbcsr.fypp:15-28``). Here a complex matrix on
such a backend stores TWO real tile stores (``BCSRMatrix.data`` /
``data_im``) and every device operation is composed from the existing REAL
ops:

- structural/linear ops (transpose, desymmetrize, redistribute, subset
  extraction, merges) map over the parts (:func:`map_parts`);
- the multiply runs as four real products
  ``(Ar'Br' − sa·sb·Ai'Bi') + i(sa·Ai'Br' + sb·Ar'Bi')`` sharing one
  symbolic plan — the classic 4-real-matmul emulation (a 3-multiply
  Karatsuba form trades one product for two extra adds; with the adds
  being tile-aligned memory passes, 4 products is the faster shape);
- reductions combine part results (trace, dot, norms).

``BCSRMatrix.parts()`` carries symmetry into the parts (H → re 'S',
im 'A'), so desymmetrize/fold compose for hermitian matrices with no
special cases here.

Filtering note: emulated complex multiplies apply ``filter_eps`` as the
mandatory post-multiply block filter on COMPLEX block norms; the plan-time
norm screening runs per real product, so the computed set is a superset of
a native complex run's (same final kept-block semantics).
"""
from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..block.bcsr import BCSRMatrix, SYM_NONE
from ..core.errors import dbcsr_assert

__all__ = [
    "map_parts",
    "lift",
    "emu_add",
    "emu_scale",
    "emu_multiply",
    "emu_hadamard",
    "emu_trace",
    "emu_dot",
    "emu_filter",
    "emu_block_norms_sq",
]


def map_parts(m: BCSRMatrix, fn, *, sym: Optional[str] = None) -> BCSRMatrix:
    """Apply a LINEAR structural op to both parts and recombine. Valid for
    any fn with fn(x+y) = fn(x)+fn(y) acting identically on both stores
    (transpose, redistribute, extraction, scaling by a real factor...)."""
    re, im = m.parts()
    rr = fn(re)
    ii = fn(im)
    out_sym = sym if sym is not None else rr.sym
    return BCSRMatrix.combine(
        rr, ii, m.dtype, name=m.name, sym=out_sym
    )


def lift(m: BCSRMatrix, cdtype) -> BCSRMatrix:
    """A real matrix viewed as an emulated complex one (zero imaginary)."""
    if m.is_complex_emulated:
        return m
    return BCSRMatrix.combine(
        m,
        m.with_data(jnp.zeros_like(m.data)),
        cdtype,
        name=m.name,
        sym=m.sym,
    )


def _parts_or_lift(m: BCSRMatrix, cdtype):
    return lift(m, cdtype).parts()


def emu_scale(m: BCSRMatrix, alpha) -> BCSRMatrix:
    from .arithmetic import add

    alpha = complex(alpha)
    re, im = m.parts()
    rr = add(alpha.real, re, -alpha.imag, im)
    ii = add(alpha.imag, re, alpha.real, im)
    return BCSRMatrix.combine(rr, ii, m.dtype, name=m.name, sym=m.sym)


def emu_add(alpha, a: BCSRMatrix, beta, b: BCSRMatrix) -> BCSRMatrix:
    from .arithmetic import add

    cdtype = np.promote_types(a.dtype, b.dtype)
    ar, ai = _parts_or_lift(a, cdtype)
    br, bi = _parts_or_lift(b, cdtype)
    alpha, beta = complex(alpha), complex(beta)
    a2r = add(alpha.real, ar, -alpha.imag, ai)
    a2i = add(alpha.imag, ar, alpha.real, ai)
    b2r = add(beta.real, br, -beta.imag, bi)
    b2i = add(beta.imag, br, beta.real, bi)
    rr = add(1.0, a2r, 1.0, b2r)
    ii = add(1.0, a2i, 1.0, b2i)
    return BCSRMatrix.combine(rr, ii, cdtype, name=a.name, sym=rr.sym)


def emu_hadamard(a: BCSRMatrix, b: BCSRMatrix) -> BCSRMatrix:
    from .arithmetic import add, hadamard_product

    cdtype = np.promote_types(a.dtype, b.dtype)
    ar, ai = _parts_or_lift(a, cdtype)
    br, bi = _parts_or_lift(b, cdtype)
    rr = add(1.0, hadamard_product(ar, br), -1.0, hadamard_product(ai, bi))
    ii = add(1.0, hadamard_product(ar, bi), 1.0, hadamard_product(ai, br))
    return BCSRMatrix.combine(rr, ii, cdtype, name=a.name, sym=SYM_NONE)


def emu_trace(m: BCSRMatrix):
    from .arithmetic import trace

    re, im = m.parts()
    return complex(trace(re)) + 1j * complex(trace(im))


def emu_dot(a: BCSRMatrix, b: BCSRMatrix):
    """Tr(A^H B) = Σ conj(a)·b composed from four real dots."""
    from .arithmetic import dot

    cdtype = np.promote_types(a.dtype, b.dtype)
    ar, ai = _parts_or_lift(a, cdtype)
    br, bi = _parts_or_lift(b, cdtype)
    re = dot(ar, br) + dot(ai, bi)
    im = dot(ar, bi) - dot(ai, br)
    return complex(re) + 1j * complex(im)


def emu_block_norms_sq(m: BCSRMatrix) -> np.ndarray:
    from ..block.tileops import block_sums_sq

    return block_sums_sq(m.index, m.tile, m.data) + block_sums_sq(
        m.index, m.tile, m.data_im
    )


def emu_filter(m: BCSRMatrix, eps: float) -> BCSRMatrix:
    """Frobenius block filter on COMPLEX norms; both stores keep/drop the
    same blocks (pattern parity with a native complex run)."""
    from ..block.index import build_index
    from ..block.store import store_layout
    from ..block.tileops import take_tiles, tile_align_map, valid_mask

    if m.nblks == 0 or eps is None:
        return m
    nsq = emu_block_norms_sq(m).astype(np.float64)
    keep = nsq >= float(eps) ** 2
    if keep.all():
        return m
    rows = m.index.blk_rows[keep]
    cols = m.index.col_idx[keep]
    new_index, _ = build_index(
        rows, cols, m.index.row_block_sizes, m.index.col_block_sizes
    )
    keys = store_layout(new_index, m.tile).tile_keys()
    amap = tile_align_map(keys, m.layout.tile_keys())
    vm = valid_mask(new_index, m.tile)
    re = take_tiles(m.data, amap, m.tile) * vm.astype(m.data.dtype)
    im = take_tiles(m.data_im, amap, m.tile) * vm.astype(m.data.dtype)
    out = BCSRMatrix(
        name=m.name, index=new_index, data=re, sym=m.sym, dist=m.dist,
        data_im=im, cdtype=m.cdtype,
    )
    return out


def emu_multiply(
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
    k_dist=None,
    limits: Optional[dict] = None,
):
    """Emulated complex ``C := alpha·op(A)·op(B) + beta·C`` (4 real
    products sharing the pattern plan + aligned adds)."""
    from ..mm.engine import multiply
    from .arithmetic import add
    from .transform import desymmetrize

    cdtype = np.promote_types(a.dtype, b.dtype)
    dbcsr_assert(
        np.issubdtype(cdtype, np.complexfloating), "emu_multiply: not complex"
    )
    a = desymmetrize(a)
    b = desymmetrize(b)
    ta = transa.upper()
    tb = transb.upper()
    sa = -1.0 if ta == "C" else 1.0
    sb = -1.0 if tb == "C" else 1.0
    ta_r = "T" if ta in ("T", "C") else "N"
    tb_r = "T" if tb in ("T", "C") else "N"
    ar, ai = _parts_or_lift(a, cdtype)
    br, bi = _parts_or_lift(b, cdtype)

    kw = dict(dist=dist, k_dist=k_dist, limits=limits)
    c_pat = None
    if retain_sparsity and c is not None:
        # a zero-valued matrix with C's pattern pins the result pattern in
        # every real product (reference retain_sparsity semantics)
        cr0 = (c.parts()[0] if c.is_complex_emulated else c)
        c_pat = cr0.with_data(jnp.zeros_like(cr0.data))
        kw["retain_sparsity"] = True

    def mult(x, y):
        out = multiply(
            ta_r, tb_r, 1.0, x, y, 0.0, c_pat, return_flops=True, **kw
        )
        return out

    m_rr, fl = mult(ar, br)
    m_ii, _ = mult(ai, bi)
    m_ir, _ = mult(ai, br)
    m_ri, _ = mult(ar, bi)
    prod_re = add(1.0, m_rr, -sa * sb, m_ii)
    prod_im = add(sa, m_ir, sb, m_ri)

    alpha = complex(alpha)
    out_re = add(alpha.real, prod_re, -alpha.imag, prod_im)
    out_im = add(alpha.imag, prod_re, alpha.real, prod_im)

    beta = complex(beta)
    if c is not None and beta != 0:
        cr, ci = _parts_or_lift(desymmetrize(c), cdtype)
        out_re = add(1.0, out_re, 1.0, add(beta.real, cr, -beta.imag, ci))
        out_im = add(1.0, out_im, 1.0, add(beta.imag, cr, beta.real, ci))
    elif c is not None:
        # beta == 0 still merges C's pattern (reference semantics)
        cr, ci = _parts_or_lift(desymmetrize(c), cdtype)
        out_re = add(1.0, out_re, 0.0, cr)
        out_im = add(1.0, out_im, 0.0, ci)

    out = BCSRMatrix.combine(
        out_re, out_im, cdtype, name="product", sym=SYM_NONE
    )
    if filter_eps is not None and not retain_sparsity:
        out = emu_filter(out, filter_eps)
    if return_flops:
        return out, fl
    return out
