"""Machine abstraction: walltime, host/device memory, flush.

Analog of ``dbcsr_machine`` (``src/base/dbcsr_machine.F:45-180``,
``dbcsr_machine_posix.f90``): ``m_walltime``, ``m_memory`` (statm-based) and
friends. Device memory comes from the jax backend's
``memory_stats`` (the XLA allocator owns device memory — the reference's
mempool bookkeeping has no equivalent to manage).
"""
from __future__ import annotations

import os
import sys
import time
from typing import Dict, Optional

__all__ = [
    "m_walltime",
    "m_memory",
    "m_peak_memory",
    "m_flush",
    "m_energy",
    "backend_supports_complex",
    "device_memory_stats",
    "setup_compile_cache",
]

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def m_walltime() -> float:
    """Monotonic wall clock in seconds (``m_walltime``)."""
    return time.monotonic()


def m_memory() -> int:
    """Current resident host memory in bytes (``m_memory``; /proc/statm
    like the reference's posix implementation)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE
    except (OSError, IndexError, ValueError):
        return 0


def m_peak_memory() -> int:
    """Peak resident host memory in bytes (VmHWM)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    except (OSError, IndexError, ValueError):
        pass
    return 0


def m_flush(stream=None) -> None:
    """Flush an output stream (``m_flush``)."""
    (stream or sys.stdout).flush()


#: platform -> native complex support override (the CPU and GPU backends
#: both do complex natively; an entry set to False forces the
#: split-complex emulation, ops/complex_emu.py — tests use that)
_COMPLEX_OK: dict = {}


def backend_supports_complex() -> bool:
    """Whether the default backend does complex arithmetic natively."""
    import jax

    return _COMPLEX_OK.get(jax.devices()[0].platform, True)


CHECKOUT_DIR = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at
    ``JAX_COMPILATION_CACHE_DIR`` when it is set, else at ``.jax_cache``
    in the root of this checkout (a fixed path: the path is part of the
    cache's key); returns the directory. Call before the first
    compilation."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        CHECKOUT_DIR, ".jax_cache"
    )
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def m_energy() -> float:
    """Cumulative energy counter in joules (``m_energy``,
    ``src/base/dbcsr_machine.F:54-180``: Cray PM counters there, 0.0
    elsewhere). Reads the host RAPL counter when the kernel exposes it;
    returns 0.0 otherwise, exactly like the reference off-Cray."""
    try:
        with open(
            "/sys/class/powercap/intel-rapl:0/energy_uj"
        ) as f:
            return int(f.read()) / 1e6
    except (OSError, ValueError):
        return 0.0


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """Device allocator statistics (bytes_in_use, peak_bytes_in_use, ...)
    if the backend exposes them — this library's view of the reference's
    per-multiply peak-memory tracking (``dbcsr_mm_cannon.F:1723``)."""
    import jax

    dev = device or jax.devices()[0]
    try:
        return dev.memory_stats()
    except Exception:
        return None
