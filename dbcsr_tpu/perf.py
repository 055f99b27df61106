"""Performance driver: runs `.perf` benchmark recipes.

Analog of the reference's ``dbcsr_perf`` executable
(``tests/dbcsr_performance_driver.F`` + ``dbcsr_performance_multiply.F:
66-450``): parses the same input format (``tests/input.perf:1-40`` — grid,
RMA flag, operation, M/N/K, sparsities, transposes, symmetries, data type,
alpha/beta, limits, retain-sparsity, nrep, block-size recipes, optional
checksum reference) and reports per-rep flop rates, mean/std wall time and
load imbalance (``perf_multiply``, ``:452-640``).

Mapping: "MPI grid" becomes the device mesh (npcols=0 → single chip or
the full mesh); the RMA flag selects nothing (XLA owns transport) and is
reported as ignored. Matrices are generated with this library's RNG, so
checksum references recorded by the Fortran driver are not comparable —
checksums are printed and only checked against references from this
driver's numpy f64 oracle (``tools/apply_checksums.py``).

Run: ``python -m dbcsr_tpu.perf tests/inputs/square_sparse.perf``
"""
from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

__all__ = [
    "PerfConfig",
    "parse_perf",
    "make_operands",
    "dense_host",
    "oracle_dense",
    "dense_checksum",
    "run_perf",
    "main",
]

_DTYPES = {1: np.float32, 3: np.float64, 5: np.complex64, 7: np.complex128}


@dataclass
class PerfConfig:
    npcols: int = 0
    use_rma: bool = False
    operation: str = "dbcsr_multiply"
    m: int = 0
    n: int = 0
    k: int = 0
    sparsity_a: float = 0.0
    sparsity_b: float = 0.0
    sparsity_c: float = 0.0
    transa: str = "N"
    transb: str = "N"
    sym_a: str = "N"
    sym_b: str = "N"
    sym_c: str = "N"
    data_type: int = 3
    alpha: complex = 1.0
    beta: complex = 1.0
    lim_row: Tuple[int, int] = (0, 0)
    lim_col: Tuple[int, int] = (0, 0)
    lim_k: Tuple[int, int] = (0, 0)
    retain_sparsity: bool = False
    nrep: int = 1
    m_blocks: List[Tuple[int, int]] = field(default_factory=list)
    n_blocks: List[Tuple[int, int]] = field(default_factory=list)
    k_blocks: List[Tuple[int, int]] = field(default_factory=list)
    check_checksum: bool = False
    checksum_threshold: float = 0.0
    checksum_refs: List[float] = field(default_factory=list)


def _f(tok: str) -> float:
    return float(tok.lower().replace("d", "e"))


def _b(tok: str) -> bool:
    return tok.strip().upper().startswith("T")


def parse_perf(path: str) -> PerfConfig:
    """Parse the reference's `.perf` input format (values-only lines;
    ``#`` comments; fixed field order — ``tests/input.perf``)."""
    with open(path) as fh:
        toks = [
            line.strip()
            for line in fh
            if line.strip() and not line.strip().startswith("#")
        ]
    it = iter(toks)
    nxt = lambda: next(it)
    cfg = PerfConfig()
    cfg.npcols = int(nxt())
    cfg.use_rma = _b(nxt())
    cfg.operation = nxt()
    cfg.m, cfg.n, cfg.k = int(nxt()), int(nxt()), int(nxt())
    cfg.sparsity_a, cfg.sparsity_b, cfg.sparsity_c = _f(nxt()), _f(nxt()), _f(nxt())
    cfg.transa, cfg.transb = nxt().upper(), nxt().upper()
    cfg.sym_a, cfg.sym_b, cfg.sym_c = nxt().upper(), nxt().upper(), nxt().upper()
    cfg.data_type = int(nxt())
    cfg.alpha = complex(_f(nxt()), _f(nxt()))
    cfg.beta = complex(_f(nxt()), _f(nxt()))
    cfg.lim_row = (int(nxt()), int(nxt()))
    cfg.lim_col = (int(nxt()), int(nxt()))
    cfg.lim_k = (int(nxt()), int(nxt()))
    cfg.retain_sparsity = _b(nxt())
    cfg.nrep = int(nxt())
    nm, nn, nk = int(nxt()), int(nxt()), int(nxt())
    cfg.m_blocks = [(int(nxt()), int(nxt())) for _ in range(nm)]
    cfg.n_blocks = [(int(nxt()), int(nxt())) for _ in range(nn)]
    cfg.k_blocks = [(int(nxt()), int(nxt())) for _ in range(nk)]
    cfg.check_checksum = _b(nxt())
    if cfg.check_checksum:
        cfg.checksum_threshold = _f(nxt())
        for tok in it:
            cfg.checksum_refs.append(_f(tok))
    return cfg


def _block_sizes(total: int, recipe: List[Tuple[int, int]]) -> np.ndarray:
    """Expand a (multiplicity, size) recipe cyclically until ``total`` full
    rows are covered (the reference's block-size generation,
    ``tests/input.perf`` block comments)."""
    sizes: List[int] = []
    covered = 0
    while covered < total:
        for mult, size in recipe:
            for _ in range(mult):
                take = min(size, total - covered)
                if take <= 0:
                    break
                sizes.append(take)
                covered += take
            if covered >= total:
                break
    return np.asarray(sizes, dtype=np.int32)


def _elem_to_block_range(
    lim: Tuple[int, int], sizes: np.ndarray
) -> Optional[Tuple[int, int]]:
    """Element limits (1-based inclusive, 0=full) → half-open block range."""
    lo, hi = lim
    if lo == 0 and hi == 0:
        return None
    off = np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)])
    b0 = int(np.searchsorted(off, lo - 1))
    b1 = int(np.searchsorted(off, hi))
    if off[b0] != lo - 1 or off[b1] != hi:
        raise ValueError(f"limits {lim} not aligned with block boundaries")
    return (b0, b1)


def make_operands(cfg: PerfConfig, seed: int = 0) -> dict:
    """The recipe's seeded operands: ``a``, ``b``, ``c`` (None unless beta
    or retain-sparsity needs it), scalars ``alpha``/``beta`` and the
    block-range ``limits``."""
    import dbcsr_tpu as dt

    dtype = _DTYPES[cfg.data_type]
    rng = np.random.default_rng(seed)
    mbs = _block_sizes(cfg.m, cfg.m_blocks)
    nbs = _block_sizes(cfg.n, cfg.n_blocks)
    kbs = _block_sizes(cfg.k, cfg.k_blocks)

    occ_a, occ_b, occ_c = (
        1.0 - cfg.sparsity_a, 1.0 - cfg.sparsity_b, 1.0 - cfg.sparsity_c,
    )
    ta = cfg.transa in ("T", "C")
    tb = cfg.transb in ("T", "C")
    a = dt.random_matrix(
        kbs if ta else mbs, mbs if ta else kbs, occ_a, rng,
        dtype=dtype, sym=cfg.sym_a, name="A",
    )
    b = dt.random_matrix(
        nbs if tb else kbs, kbs if tb else nbs, occ_b, rng,
        dtype=dtype, sym=cfg.sym_b, name="B",
    )
    c = None
    if cfg.beta != 0.0 or cfg.retain_sparsity:
        c = dt.random_matrix(mbs, nbs, occ_c, rng, dtype=dtype, name="C")

    limits = {}
    for key, lim, sizes in (
        ("rows", cfg.lim_row, mbs), ("cols", cfg.lim_col, nbs),
        ("k", cfg.lim_k, kbs),
    ):
        rng_blocks = _elem_to_block_range(lim, sizes)
        if rng_blocks is not None:
            limits[key] = rng_blocks

    cplx = np.iscomplexobj(np.empty(0, dtype))
    return {
        "a": a, "b": b, "c": c, "limits": limits,
        "alpha": cfg.alpha if cplx else cfg.alpha.real,
        "beta": cfg.beta if cplx else cfg.beta.real,
    }


def dense_host(m) -> np.ndarray:
    """Dense numpy copy of a non-symmetric matrix, assembled on the host
    from its block data (no device arithmetic)."""
    if m.sym != "N":
        raise ValueError("dense_host takes non-symmetric matrices")
    idx = m.index
    flat = m.flat_host()
    out = np.zeros(
        (int(idx.row_offsets[-1]), int(idx.col_offsets[-1])), flat.dtype
    )
    _, bn = idx.blk_shapes
    b_of = idx.elem_to_blk
    off = np.arange(flat.size, dtype=np.int64) - idx.blk_offset[b_of]
    ncols = bn[b_of].astype(np.int64)
    rows = idx.row_offsets[idx.blk_rows[b_of]] + off // ncols
    cols = idx.col_offsets[idx.col_idx[b_of]] + off % ncols
    out[rows, cols] = flat
    return out


def oracle_dense(cfg: PerfConfig, ops: dict) -> np.ndarray:
    """The recipe's result as a numpy f64 (c128 for complex) dense product
    of the seeded operands: ``alpha op(A) op(B) + beta C``. Recipes with
    limits or retain-sparsity are outside its scope."""
    if ops["limits"] or cfg.retain_sparsity:
        raise ValueError("oracle_dense: limits/retain-sparsity unsupported")
    wide = np.complex128 if np.iscomplexobj(
        np.empty(0, _DTYPES[cfg.data_type])
    ) else np.float64

    def op(m, trans):
        d = dense_host(m).astype(wide)
        if trans == "T":
            return d.T
        return d.conj().T if trans == "C" else d

    out = ops["alpha"] * (op(ops["a"], cfg.transa) @ op(ops["b"], cfg.transb))
    if ops["c"] is not None:
        out = out + ops["beta"] * dense_host(ops["c"]).astype(wide)
    return out


def dense_checksum(d: np.ndarray) -> float:
    """Position-weighted checksum (``ops.io.checksum(pos=True)``) of a dense
    result: zeros outside the stored pattern contribute nothing, so this
    equals the checksum of the engine's sparse result."""
    gr = np.arange(1, d.shape[0] + 1, dtype=np.float64)[:, None]
    gc = np.arange(1, d.shape[1] + 1, dtype=np.float64)[None, :]
    return float((d.real * np.log(gr * gc)).sum())


def run_perf(cfg: PerfConfig, *, seed: int = 0, verbose: bool = True,
             return_product: bool = False):
    """Run the recipe; returns the result record (and the product matrix
    when ``return_product``)."""
    import jax

    import dbcsr_tpu as dt

    if cfg.use_rma and verbose:
        print("# note: RMA flag ignored (XLA owns device transport)")
    ops = make_operands(cfg, seed)
    a, b, c = ops["a"], ops["b"], ops["c"]
    alpha, beta, limits = ops["alpha"], ops["beta"], ops["limits"]

    times = []
    flops = 0.0
    out = None
    for rep in range(cfg.nrep):
        t0 = time.perf_counter()
        out, fl = dt.multiply(
            cfg.transa, cfg.transb, alpha, a, b, beta, c,
            retain_sparsity=cfg.retain_sparsity,
            limits=limits or None,
            return_flops=True,
        )
        out.data.block_until_ready()
        times.append(time.perf_counter() - t0)
        flops = fl
    times = np.asarray(times)
    mean_t = float(times.mean())
    std_t = float(times.std())
    best_t = float(times.min())
    n_dev = len(jax.devices())
    cks = dt.checksum(out, pos=True)
    result = {
        "operation": cfg.operation,
        "mnk": [cfg.m, cfg.n, cfg.k],
        "nrep": cfg.nrep,
        "eff_flops_per_mult": flops,
        "mean_time_s": mean_t,
        "std_time_s": std_t,
        "best_time_s": best_t,
        "flops_per_s_mean": flops / mean_t if mean_t else 0.0,
        "flops_per_s_best": flops / best_t if best_t else 0.0,
        "flops_per_device": (flops / mean_t / n_dev) if mean_t else 0.0,
        "n_devices": n_dev,
        "checksum": cks,
    }
    if cfg.check_checksum and cfg.checksum_refs:
        ok = any(
            abs(cks - ref) <= cfg.checksum_threshold * max(abs(ref), 1.0)
            for ref in cfg.checksum_refs
        )
        result["checksum_match"] = bool(ok)

    # steady-state device rate of the plain product (plan-once executor,
    # marginal-time methodology — the per-call numbers above include host
    # planning and dispatch, which the reference's driver also measures)
    from .autotune import steady_state_time
    from .mm.engine import build_multiply_executor

    fn, _, eff_x = build_multiply_executor(cfg.transa, cfg.transb, a, b)
    t_steady = steady_state_time(fn, (a.data, b.data))
    result["steady_time_s"] = t_steady
    result["flops_per_s_steady"] = eff_x / t_steady

    if verbose:
        print(
            f" multiplies {cfg.nrep}   mean {mean_t*1e3:9.3f} ms  "
            f"std {std_t*1e3:7.3f} ms"
        )
        print(
            f" eff flops/mult {flops:.4E}   "
            f"GFLOP/s mean {result['flops_per_s_mean']/1e9:9.2f}  "
            f"best {result['flops_per_s_best']/1e9:9.2f}"
        )
        if result.get("flops_per_s_steady"):
            print(
                f" steady-state executor  "
                f"GFLOP/s {result['flops_per_s_steady']/1e9:9.2f}"
            )
        print(f" checksum {cks:.15E}")
        print(json.dumps(result))
    if return_product:
        return result, out
    return result


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m dbcsr_tpu.perf <input.perf> [seed]")
        return 2
    from .core import init_lib
    from .core.machine import setup_compile_cache

    setup_compile_cache()
    init_lib()  # f64 recipes need 64-bit types
    cfg = parse_perf(argv[0])
    seed = int(argv[1]) if len(argv) > 1 else 0
    res = run_perf(cfg, seed=seed)
    if cfg.check_checksum and cfg.checksum_refs:
        ok = res.get("checksum_match", False)
        print(f"checksum check: {'OK' if ok else 'MISMATCH'}")
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
