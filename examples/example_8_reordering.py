"""Example 8: locality-aware block renumbering (the dense-limit pre-pass).

Real linear-scaling-SCF matrices are near-sighted — blocks couple only to
spatial neighbors — but the ATOM NUMBERING handed to the library rarely
exposes that locality, and the tile store packs ~T/avg_block CONSECUTIVE
block rows per 128x128 hardware tile. A clustered-but-scrambled numbering
therefore shatters tile packing (measured ~16x tile blow-up), and no
tile-level pass can recover it after the fact.

This library's fix is a one-time construction pre-pass, the analog of the
reference's dense-friendly-ordering requirement for its dense-limit path
(``dbcsr_may_be_dense``/make_dense, ``src/mm/dbcsr_mm.F:771-810``):
``locality_block_permutation`` runs Reverse-Cuthill-McKee on the block
graph to recover the hidden locality axis, ``permute_blocks`` renumbers
the matrix, and every subsequent multiply in the iterative loop gets
compact tiles (and panel-kernel admissibility) for free. Undo with the
inverse permutation when exporting results.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def main():
    import dbcsr_tpu as dt

    dt.init_lib()
    rng = np.random.default_rng(0)

    # hidden 1-D chain with exponential-decay coupling ...
    n = 600
    sizes = rng.choice([5, 13], size=n).astype(np.int32)
    dmax = 8
    i = np.repeat(np.arange(n, dtype=np.int64), 2 * dmax + 1)
    off = np.tile(np.arange(-dmax, dmax + 1, dtype=np.int64), n)
    j = i + off
    keep = (
        (j >= 0) & (j < n)
        & (rng.random(len(j)) < np.exp(-np.abs(off) / 3.0))
    )
    # ... then SCRAMBLE the block numbering (atom order hides the chain)
    sig = rng.permutation(n).astype(np.int64)
    rows, cols = sig[i[keep]], sig[j[keep]]
    rbs = np.empty(n, np.int32)
    rbs[sig] = sizes

    blocks = [
        rng.standard_normal((rbs[r], rbs[c])).astype(np.float32)
        for r, c in zip(rows, cols)
    ]
    a = dt.BCSRMatrix.from_blocks(rows, cols, blocks, rbs, rbs, name="A")
    print(f"scrambled numbering: {a.index.nblks} blocks -> "
          f"{a.layout.n_tiles} hardware tiles")

    # recover the locality axis and renumber
    pm, pk, pn = dt.locality_block_permutation(a.index)
    ar = dt.permute_blocks(a, pm, pn)
    print(f"RCM-recovered:       {ar.index.nblks} blocks -> "
          f"{ar.layout.n_tiles} hardware tiles "
          f"({a.layout.n_tiles / ar.layout.n_tiles:.1f}x denser)")

    # the product of renumbered operands IS the renumbered product
    c_scr = dt.multiply("N", "N", 1.0, a, a)
    c_ord = dt.multiply("N", "N", 1.0, ar, ar)
    want = np.asarray(dt.permute_blocks(c_scr, pm, pn).to_dense())
    err = np.abs(np.asarray(c_ord.to_dense()) - want).max()
    print(f"renumbered product matches: max err {err:.2e}")

    # undo for export: inverse permutation restores the caller's order
    back = dt.permute_blocks(ar, np.argsort(pm), np.argsort(pn))
    assert np.array_equal(
        np.asarray(back.to_dense()), np.asarray(a.to_dense())
    )
    print("inverse permutation restores the original numbering")


if __name__ == "__main__":
    main()
