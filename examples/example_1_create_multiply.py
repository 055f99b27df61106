"""Example 1: assemble two block-sparse matrices and multiply them.

This library's analog of the reference's ``examples/dbcsr_example_1-3.F``
workflow: init the library, build matrices block-by-block, multiply with
epsilon filtering, inspect the result and the statistics report.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

import dbcsr_tpu as dt


def main():
    dt.init_lib()

    # block structure: 4 block rows/cols of mixed sizes
    sizes = np.array([2, 3, 5, 2], dtype=np.int32)

    rng = np.random.default_rng(0)
    a_builder = dt.BCSRBuilder(sizes, sizes, name="A", dtype=np.float64)
    b_builder = dt.BCSRBuilder(sizes, sizes, name="B", dtype=np.float64)
    for i in range(4):
        for j in range(4):
            if rng.random() < 0.5:
                a_builder.put_block(i, j, rng.standard_normal((sizes[i], sizes[j])))
            if rng.random() < 0.5:
                b_builder.put_block(i, j, rng.standard_normal((sizes[i], sizes[j])))
    a = a_builder.finalize()
    b = b_builder.finalize()

    c = dt.multiply("N", "N", 1.0, a, b, filter_eps=1e-10)

    dt.print_matrix(c, values=False)
    print(f"checksum(C) = {dt.checksum(c):.12e}")
    print(dt.print_statistics())
    dt.finalize_lib()


if __name__ == "__main__":
    main()
