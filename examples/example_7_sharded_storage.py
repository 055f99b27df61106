"""Example 7: sharded at-rest storage — a full iterative loop where the
matrices live owner-partitioned across the mesh the whole time.

The memory-scaling story: `shard_matrix` splits a matrix's tile data by
owner device (the distribution's bins); `sharded_multiply` and the sharded
elementwise/reduction ops (`sharded_add`, `sharded_filter`,
`sharded_trace`, ...) consume and produce that form directly, so nothing
ever gathers to one host — the Analog of the reference keeping
each rank's `data_area` local for the life of the computation.

Run with a virtual CPU mesh to see real sharding on one machine:

  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/example_7_sharded_storage.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def main():
    import jax

    if os.environ.get("JAX_PLATFORMS"):
        jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

    import dbcsr_tpu as dt
    from dbcsr_tpu.dist import (
        ProcessGrid,
        shard_matrix,
        sharded_add,
        sharded_filter,
        sharded_frobenius,
        sharded_multiply,
        sharded_trace,
    )
    from dbcsr_tpu.dist.distribution import tile_aligned_dist

    dt.init_lib()
    n = len(jax.devices())
    p = int(np.sqrt(n))
    while p > 1 and n % p:
        p -= 1
    q = n // p
    grid = ProcessGrid.make(p, q)
    print(f"mesh: {p} x {q} ({n} devices)")

    rng = np.random.default_rng(0)
    rbs = dt.random_block_sizes(400, [5, 13], rng)
    dist = tile_aligned_dist(grid, rbs, rbs, dt.get_config().tile_size)

    # a random symmetric-ish sparse matrix, sharded by owner
    h = dt.random_matrix(rbs, rbs, 0.15, rng, dtype=np.float32, name="H")
    h = dt.add(0.5, h, 0.5, dt.transpose(h))
    sh = shard_matrix(h, dist)
    print(f"H: {sh.nblks} blocks, per-device tile store "
          f"[{sh.shard.ndev}, {sh.shard.n_max}, {sh.tile}, {sh.tile}]")

    # a damped matrix-polynomial iteration, fully sharded:
    #   X <- 0.5 * (X·H + X),  filtered each step
    x = sh
    for it in range(3):
        xh = sharded_multiply("N", "N", 1.0, x, sh)
        x = sharded_add(0.5, xh, 0.5, x)
        x = sharded_filter(x, 1e-6)
        print(f"  iter {it}: {x.nblks} blocks, "
              f"trace {sharded_trace(x):+.4f}, "
              f"||X||_F {sharded_frobenius(x):.4f}")

    # verify against the replicated-local pipeline
    y = h
    for _ in range(3):
        y = dt.filter_blocks(
            dt.add(0.5, dt.multiply("N", "N", 1.0, y, h), 0.5, y), 1e-6
        )
    yd = np.asarray(y.to_dense())
    err = np.abs(np.asarray(x.to_local().to_dense()) - yd).max()
    scale = max(1.0, float(np.abs(yd).max()))
    print(f"max |sharded - local| = {err:.2e} (rel {err / scale:.2e})")
    assert err < 1e-5 * scale


if __name__ == "__main__":
    main()
