"""Library lifecycle: init / finalize / statistics.

Analog of ``dbcsr_init_lib`` / ``dbcsr_finalize_lib``
(``src/core/dbcsr_lib.F:122-396``). Here there is no MPI world or
accelerator context to set up — JAX owns the runtime — so init reduces to:
config load (env overrides), optional ``jax.distributed`` initialization for
multi-host meshes, timer/stat reset, and precision defaults.
"""
from __future__ import annotations

from typing import Optional

import jax

from .config import get_config
from .stats import print_statistics, reset_stats
from .timing import reset_timers, timer_report

__all__ = ["init_lib", "finalize_lib", "print_statistics", "is_initialized"]

_initialized = False


def init_lib(
    *,
    distributed: bool = False,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    enable_x64: bool = True,
) -> None:
    """Initialize the library.

    ``distributed=True`` brings up ``jax.distributed`` (the analog of the
    reference's MPI_Init-time setup); on single-host it is a no-op.

    ``enable_x64`` (default on) enables 64-bit types in jax — the reference
    is a double-precision-first library, and without this flag f64/c128
    matrices silently degrade to f32/c64 on device. Pass False for
    pure-f32/bf16 throughput workloads.
    """
    global _initialized
    if _initialized:
        return
    cfg = get_config()  # triggers DBCSR_* env var loading
    if enable_x64:
        jax.config.update("jax_enable_x64", True)
    if distributed:
        kwargs = {}
        if coordinator_address is not None:
            kwargs["coordinator_address"] = coordinator_address
        if num_processes is not None:
            kwargs["num_processes"] = num_processes
        if process_id is not None:
            kwargs["process_id"] = process_id
        jax.distributed.initialize(**kwargs)
    if cfg.matmul_precision in ("default", "high", "highest"):
        jax.config.update("jax_default_matmul_precision", cfg.matmul_precision)
    reset_stats()
    reset_timers()
    _initialized = True


def is_initialized() -> bool:
    return _initialized


def finalize_lib(print_stats: bool = False, out=None) -> None:
    """Finalize: optionally print statistics + timer report
    (reference: stats print at ``src/core/dbcsr_lib.F:296-396``)."""
    global _initialized
    if print_stats:
        print_statistics(out=out)
        timer_report(out=out)
    _initialized = False
