"""Example 9: line-for-line port of the reference's C-API worked example
``dbcsr_example_3.cpp`` (``/root/reference/examples/dbcsr_example_3.cpp``).

The migration story, made explicit — every step of the original maps to
one step here:

| reference (C API + MPI)                      | dbcsr_tpu                  |
|----------------------------------------------|----------------------------|
| MPI_Cart_create 2-D grid                     | ``dt.ProcessGrid(p, q)``   |
| ``random_dist`` round-robin ``i % nbins``    | same vectors, ``Distribution`` |
| ``c_dbcsr_create_new`` + reserve + iterator fill | ``BCSRBuilder.put_block``  |
| ``c_dbcsr_finalize``                         | ``builder.finalize()``     |
| ``c_dbcsr_multiply_d('N','N',3,A,B,2,C)``    | ``dt.multiply('N','N',3,A,B,2,C)`` |
| ``c_dbcsr_print``                            | ``dt.print_matrix``        |

Same shapes, same block sizes, same non-zero block lists as the
original. Runs distributed over a 2x2 device mesh when 4+ devices exist
(set ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` with
``JAX_PLATFORMS=cpu`` to rehearse multi-device), local otherwise.
Validated against a dense oracle — the script FAILS loudly if the port
ever diverges from the reference semantics.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

import dbcsr_tpu as dt


def random_dist(dist_size: int, nbins: int) -> np.ndarray:
    """The reference's round-robin block distribution (example_3.cpp:24)."""
    return np.arange(dist_size, dtype=np.int64) % nbins


def fill_matrix(name, row_sizes, col_sizes, irblks, icblks, rng):
    """create_new + reserve_blocks + iterator fill (example_3.cpp:94-130):
    every listed block exists and is filled with uniform [0,1) randoms."""
    b = dt.BCSRBuilder(row_sizes, col_sizes, name=name, dtype=np.float64)
    for i, j in zip(irblks, icblks):
        b.put_block(i, j, rng.random((row_sizes[i], col_sizes[j])))
    return b.finalize()


def main():
    dt.init_lib()

    # block sizes (example_3.cpp:72-75)
    row_blk_1 = np.array([2, 3, 5, 2], dtype=np.int32)
    col_blk_1 = np.array([3, 3, 4, 6, 2], dtype=np.int32)
    row_blk_2 = col_blk_1
    col_blk_2 = np.array([5, 2, 5, 3], dtype=np.int32)

    # non-zero block lists (example_3.cpp:146-153)
    irblks_1 = [0, 0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3]
    icblks_1 = [0, 1, 2, 4, 0, 2, 3, 1, 3, 4, 0, 1, 2]
    irblks_2 = [0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 4]
    icblks_2 = [0, 2, 3, 0, 1, 2, 3, 0, 2, 3, 1, 2, 3, 0, 1, 2, 3]
    irblks_3 = [0, 0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3]
    icblks_3 = [0, 1, 2, 3, 0, 2, 3, 1, 2, 3, 0, 1, 2, 3]

    rng = np.random.default_rng(42)
    a = fill_matrix("matrix a", row_blk_1, col_blk_1, irblks_1, icblks_1, rng)
    b = fill_matrix("matrix b", row_blk_2, col_blk_2, irblks_2, icblks_2, rng)
    c = fill_matrix("matrix c", row_blk_1, col_blk_2, irblks_3, icblks_3, rng)

    # oracle BEFORE the multiply (dense copies of the assembled inputs)
    da, db, dc = (np.asarray(m.to_dense()) for m in (a, b, c))

    # 2-D grid + round-robin distributions (example_3.cpp:44-91); the
    # MPI cart grid becomes a device mesh when enough devices exist
    import jax

    from dbcsr_tpu.dist.distribution import Distribution
    from dbcsr_tpu.dist.grid import ProcessGrid

    dist = None
    if len(jax.devices()) >= 4:
        grid = ProcessGrid.make(2, 2)
        dist = Distribution(
            grid=grid,
            row_dist=random_dist(len(row_blk_1), 2),
            col_dist=random_dist(len(col_blk_2), 2),
        )
        print(f"grid: 2x2 over {jax.devices()[0].platform} devices")
    else:
        print("fewer than 4 devices — running the local engine")

    # C = 3.0 * A * B + 2.0 * C   (example_3.cpp:163)
    c = dt.multiply("N", "N", 3.0, a, b, 2.0, c, dist=dist)

    ref = 3.0 * (da @ db) + 2.0 * dc
    err = np.abs(np.asarray(c.to_dense()) - ref).max()
    scale = np.abs(ref).max()
    print(f"C = 3*A*B + 2*C: {c.nblks} blocks, max err {err:.2e}")

    # expected-output checks (the c_dbcsr_print analog, made assertive)
    assert err <= 1e-12 * scale, "result diverges from the dense oracle"
    # the product adds blocks beyond C's initial 14 (no retain_sparsity)
    assert c.nblks >= 14, "product lost preexisting C blocks"
    assert c.index.nblkrows == 4 and c.index.nblkcols == 4
    dt.print_matrix(c, values=False)
    print("OK — reference example 3 semantics reproduced")


if __name__ == "__main__":
    main()
