"""Built-in self-test API.

Analog of the reference's embedded test infrastructure
(``dbcsr_run_tests`` / ``dbcsr_test_mm`` / ``dbcsr_test_binary_io``,
``src/ops/dbcsr_tests.F:62``; helpers ``src/ops/dbcsr_test_methods.F``):
embedding applications can self-check the installed library on their own
machine without the pytest suite. The correctness oracle is the same as the
reference's (``tests/dbcsr_test_multiply.F:523-700``): convert operands to
replicated dense, compare ``multiply`` against dense GEMM with
norm-scaled residuals, imposing C's sparsity when ``retain_sparsity``.
"""
from __future__ import annotations

import tempfile
from typing import Optional, Sequence

import numpy as np

from .block.bcsr import BCSRMatrix
from .mm.engine import multiply
from .ops.io import binary_read, binary_write, checksum
from .ops.random import random_block_sizes, random_matrix

__all__ = [
    "to_dense_local",
    "impose_sparsity",
    "check_multiply",
    "test_mm",
    "test_binary_io",
    "test_tas",
    "test_tensor",
    "validate_kernels",
    "run_tests",
]


def _kernel_validation_cases(tile: int, n_tiles: int, seed: int,
                             interpret: bool):
    """One case per hand-written kernel and precision, each paired with
    its XLA reference. Returns ``[(name, run_kernel, run_xla, tol), ...]``
    thunks (``tol`` relative to the reference's max magnitude)."""
    import jax.numpy as jnp

    from .mm.kernels import tile_stack_matmul_crun, tile_stack_matmul_xla

    rng = np.random.default_rng(seed)
    a = jnp.asarray(rng.standard_normal((n_tiles, tile, tile)), jnp.float32)
    b = jnp.asarray(rng.standard_normal((n_tiles, tile, tile)), jnp.float32)
    # repeated C tiles exercise run accumulation; C slot 3 has an empty run
    stack = np.array(
        [[0, 0, 0], [0, 1, 1], [1, 2, 2], [2, 0, 3], [2, 3, 0], [2, 1, 2],
         [4, 3, 3]],
        dtype=np.int32,
    )
    ref = lambda: tile_stack_matmul_xla(  # noqa: E731
        a, b, jnp.asarray(stack), n_c_tiles=5, precision="highest"
    )
    cases = []
    # TF32 and bf16 keep ~3 significant digits
    for name, dtype, prec, tol in (
        ("crun-f32-highest", jnp.float32, "highest", 1e-5),
        ("crun-f32-default", jnp.float32, "default", 2e-2),
        ("crun-bf16", jnp.bfloat16, "default", 2e-2),
    ):
        cases.append((
            name,
            lambda dtype=dtype, prec=prec: tile_stack_matmul_crun(
                a.astype(dtype), b.astype(dtype), stack, n_c_tiles=5,
                precision=prec, out_dtype=jnp.float32, interpret=interpret,
            ),
            ref,
            tol,
        ))
    return cases


def validate_kernels(*, tile: int = 128, n_tiles: int = 4, seed: int = 0,
                     verbose: bool = False) -> bool:
    """Numeric self-validation of every hand-written kernel against its
    XLA reference on the current device (the reference validates every JIT
    kernel at first use, ``validate_kernel``,
    ``src/acc/libsmm_acc/libsmm_acc.cpp:55-89``). Off the GPU the kernels
    run in Pallas interpret mode, and the report says so."""
    import jax
    import jax.numpy as jnp

    interpret = jax.default_backend() != "gpu"
    mode = "interpret mode" if interpret else "compiled for the GPU"
    all_ok = True
    for name, run_kernel, run_xla, tol in _kernel_validation_cases(
        tile, n_tiles, seed, interpret
    ):
        got = run_kernel()
        ref = run_xla()
        err = float(jnp.max(jnp.abs(got.astype(jnp.float32) - ref)))
        scale = float(jnp.max(jnp.abs(ref))) or 1.0
        ok = err <= tol * scale
        if verbose or not ok:
            print(f"validate_kernels[{name}, {mode}]: max err {err:.3e} "
                  f"(scale {scale:.3e}) {'OK' if ok else 'FAILED'}")
        all_ok = all_ok and ok
    return all_ok


def to_dense_local(m: BCSRMatrix) -> np.ndarray:
    """Replicated dense copy on host (``dbcsr_to_dense_local``,
    ``src/ops/dbcsr_test_methods.F:213``)."""
    return np.asarray(m.to_dense())


def impose_sparsity(dense: np.ndarray, like: BCSRMatrix) -> np.ndarray:
    """Zero ``dense`` outside the block pattern of ``like``
    (``dbcsr_impose_sparsity``, ``src/ops/dbcsr_test_methods.F:102``)."""
    out = np.zeros_like(dense)
    ro = like.index.row_offsets
    co = like.index.col_offsets
    rows = like.index.blk_rows
    cols = like.index.col_idx
    for b in range(like.nblks):
        i, j = int(rows[b]), int(cols[b])
        out[ro[i]:ro[i + 1], co[j]:co[j + 1]] = dense[
            ro[i]:ro[i + 1], co[j]:co[j + 1]
        ]
        if like.sym != "N" and i != j:
            out[ro[j]:ro[j + 1], co[i]:co[i + 1]] = dense[
                ro[j]:ro[j + 1], co[i]:co[i + 1]
            ]
    return out


def check_multiply(
    transa: str,
    transb: str,
    alpha,
    a: BCSRMatrix,
    b: BCSRMatrix,
    beta,
    c_in: Optional[BCSRMatrix],
    c_out: BCSRMatrix,
    *,
    retain_sparsity: bool = False,
    eps_factor: float = 100.0,
) -> bool:
    """Norm-scaled residual acceptance test (``dbcsr_check_multiply``,
    ``tests/dbcsr_test_multiply.F:616-640``): accept when
    ``|C_dense − C_sparse|_max <= eps_factor · ε_machine · scale`` with
    ``scale = max(|A|, |B|, |C|)`` 1-norm products."""
    da = to_dense_local(a)
    db = to_dense_local(b)
    if transa.upper() in ("T", "C"):
        da = da.T.conj() if transa.upper() == "C" else da.T
    if transb.upper() in ("T", "C"):
        db = db.T.conj() if transb.upper() == "C" else db.T
    ref = alpha * (da @ db)
    if c_in is not None:
        ref = ref + beta * to_dense_local(c_in)
    if retain_sparsity and c_in is not None:
        ref = impose_sparsity(ref, c_in)
    got = to_dense_local(c_out)
    eps = np.finfo(np.asarray(got).real.dtype).eps
    scale = max(
        np.abs(da).sum(axis=0).max() * np.abs(db).sum(axis=0).max(),
        np.abs(ref).max(),
        1.0,
    )
    resid = np.abs(got - ref).max()
    return bool(resid <= eps_factor * eps * scale)


def test_mm(
    *,
    nblkrows: int = 60,
    nblkcols: int = 50,
    nblkks: int = 55,
    block_sizes: Sequence[int] = (2, 3, 5),
    occupancy: float = 0.3,
    dtype=np.float64,
    seed: int = 0,
    verbose: bool = False,
) -> bool:
    """Multiply self-test sweep (``dbcsr_test_mm``): transposes × alpha/beta
    on random matrices, dense-oracle checked. Returns True if all pass."""
    rng = np.random.default_rng(seed)
    mbs = random_block_sizes(nblkrows, block_sizes, rng)
    kbs = random_block_sizes(nblkks, block_sizes, rng)
    nbs = random_block_sizes(nblkcols, block_sizes, rng)
    ok = True
    for transa in ("N", "T"):
        for transb in ("N", "T"):
            a = random_matrix(
                kbs if transa == "T" else mbs,
                mbs if transa == "T" else kbs,
                occupancy, rng, dtype=dtype, name="A",
            )
            b = random_matrix(
                nbs if transb == "T" else kbs,
                kbs if transb == "T" else nbs,
                occupancy, rng, dtype=dtype, name="B",
            )
            for alpha, beta, with_c in ((1.0, 0.0, False), (2.0, 0.5, True)):
                c_in = (
                    random_matrix(mbs, nbs, occupancy, rng, dtype=dtype, name="C")
                    if with_c
                    else None
                )
                c_out = multiply(transa, transb, alpha, a, b, beta, c_in)
                good = check_multiply(
                    transa, transb, alpha, a, b, beta, c_in, c_out
                )
                if verbose or not good:
                    print(
                        f"test_mm {transa}{transb} alpha={alpha} beta={beta} "
                        f"c={'Y' if with_c else 'N'}: "
                        f"{'OK' if good else 'FAILED'}"
                    )
                ok = ok and good
    return ok


def test_binary_io(*, seed: int = 0, verbose: bool = False) -> bool:
    """Checkpoint self-test (``dbcsr_test_binary_io``): write → read →
    checksum compare."""
    rng = np.random.default_rng(seed)
    rbs = random_block_sizes(40, [2, 3, 5], rng)
    m = random_matrix(rbs, rbs, 0.3, rng, dtype=np.float64, name="io_test")
    with tempfile.NamedTemporaryFile(suffix=".dbcsr") as f:
        binary_write(m, f.name)
        m2 = binary_read(f.name)
    good = (
        m2.nblks == m.nblks
        and abs(checksum(m2) - checksum(m)) <= 1e-12 * max(checksum(m), 1.0)
    )
    if verbose or not good:
        print(f"test_binary_io: {'OK' if good else 'FAILED'}")
    return good


def test_tas(*, seed: int = 0, verbose: bool = False) -> bool:
    """TAS self-test: tall multiply vs dense oracle (the reference's
    ``dbcsr_tas_unittest`` checksum recipe in miniature)."""
    from .tas import tas_multiply

    rng = np.random.default_rng(seed)
    mbs = random_block_sizes(300, [2, 3], rng)
    kbs = random_block_sizes(24, [3], rng)
    nbs = random_block_sizes(20, [2], rng)
    a = random_matrix(mbs, kbs, 0.3, rng, dtype=np.float64, name="A")
    b = random_matrix(kbs, nbs, 0.6, rng, dtype=np.float64, name="B")
    out = tas_multiply("N", "N", 1.0, a, b, nsplit=4).matrix
    ref = to_dense_local(a) @ to_dense_local(b)
    good = bool(np.abs(to_dense_local(out) - ref).max() <= 1e-10 * max(
        np.abs(ref).max(), 1.0
    ))
    if verbose or not good:
        print(f"test_tas: {'OK' if good else 'FAILED'}")
    return good


def test_tensor(*, seed: int = 0, verbose: bool = False) -> bool:
    """Tensor self-test: rank-3 contraction vs an einsum oracle (the
    reference's ``dbcsr_t_contract_test``)."""
    from .tensors import NDMapping, TensorBuilder, contract

    rng = np.random.default_rng(seed)
    bs = [np.array([2, 3]), np.array([2, 2]), np.array([3, 1, 2])]
    bs_l = [np.array([4])]

    def build(sizes, occ, mapping=None):
        bld = TensorBuilder(sizes, mapping, dtype=np.float64)
        nbpd = [len(s) for s in sizes]
        for flat in np.flatnonzero(rng.random(int(np.prod(nbpd))) < occ):
            bi = np.unravel_index(flat, nbpd)
            shp = tuple(int(sizes[d][bi[d]]) for d in range(len(sizes)))
            bld.put_block(bi, rng.standard_normal(shp))
        return bld.finalize()

    a = build(bs, 0.7, NDMapping(3, (0, 1), (2,)))
    b = build([bs[2]] + bs_l, 0.8)
    out = contract(
        1.0, a, b,
        contract_1=(2,), notcontract_1=(0, 1),
        contract_2=(0,), notcontract_2=(1,),
    )
    ref = np.einsum("ijk,kl->ijl", np.asarray(a.to_dense()),
                    np.asarray(b.to_dense()))
    good = bool(
        np.abs(np.asarray(out.to_dense()) - ref).max()
        <= 1e-10 * max(np.abs(ref).max(), 1.0)
    )
    if verbose or not good:
        print(f"test_tensor: {'OK' if good else 'FAILED'}")
    return good


def run_tests(*, verbose: bool = False) -> bool:
    """Run every built-in self-test (``dbcsr_run_tests``)."""
    ok = test_mm(verbose=verbose)
    ok = test_binary_io(verbose=verbose) and ok
    ok = validate_kernels(verbose=verbose) and ok
    ok = test_tas(verbose=verbose) and ok
    ok = test_tensor(verbose=verbose) and ok
    if verbose:
        print(f"run_tests: {'ALL OK' if ok else 'FAILURES'}")
    return ok
