"""Multiplication statistics counters.

Analog of the reference's per-(m,n,k) stack statistics and flop accounting
(``src/mm/dbcsr_mm_sched.F:392-663``, ``dbcsr_mm.F:214-305``) reported via
``dbcsr_print_statistics`` (``src/core/dbcsr_lib.F:348``).

Effective flops are counted at user-block granularity (2*m*n*k per stack
entry); hardware flops at tile granularity — the ratio is the tile packing
efficiency of the two-level block/tile design (see ARCHITECTURE.md).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

__all__ = ["MMStats", "get_stats", "reset_stats", "print_statistics"]


@dataclass
class MMStats:
    #: (m, n, k) -> (num_blocks, effective_flops)
    by_mnk: Dict[Tuple[int, int, int], Tuple[int, float]] = field(default_factory=dict)
    num_multiplications: int = 0
    total_flops: float = 0.0  # effective, 2*m*n*k per surviving entry
    hardware_flops: float = 0.0  # tile-granular flops actually issued
    num_stacks: int = 0
    total_stack_entries: int = 0
    max_memory_bytes: int = 0
    #: (collective kind, size decade) -> (message count, total bytes) —
    #: the analog of the reference's MPI message statistics with size
    #: buckets (``dbcsr_mpi_statistics_type``, ``dbcsr_types.F:578-589``)
    comm_msgs: Dict[Tuple[str, int], Tuple[int, float]] = field(
        default_factory=dict
    )
    #: product route -> times the engine chose it (``mm.engine.select_route``)
    routes: Dict[str, int] = field(default_factory=dict)

    def record_route(self, kind: str) -> None:
        self.routes[kind] = self.routes.get(kind, 0) + 1

    def record_stack(self, m: int, n: int, k: int, nblocks: int) -> None:
        flops = 2.0 * m * n * k * nblocks
        cnt, fl = self.by_mnk.get((m, n, k), (0, 0.0))
        self.by_mnk[(m, n, k)] = (cnt + nblocks, fl + flops)
        self.total_flops += flops
        self.num_stacks += 1
        self.total_stack_entries += nblocks

    def record_comm(self, kind: str, count: int, msg_bytes: float) -> None:
        """Record ``count`` device-to-device messages of ``msg_bytes``
        each (computed statically from the collective's panel shapes)."""
        if count <= 0 or msg_bytes <= 0:
            return
        bucket = 0
        b = msg_bytes
        while b >= 10:
            b /= 10
            bucket += 1
        cnt, tot = self.comm_msgs.get((kind, bucket), (0, 0.0))
        self.comm_msgs[(kind, bucket)] = (
            cnt + count, tot + count * msg_bytes
        )


_stats = MMStats()


def get_stats() -> MMStats:
    return _stats


def reset_stats() -> None:
    global _stats
    _stats = MMStats()


def print_statistics(out=None) -> str:
    s = _stats
    lines = ["-" * 72, " DBCSR STATISTICS", "-" * 72]
    lines.append(f" multiplications          {s.num_multiplications}")
    lines.append(f" effective flops          {s.total_flops:.6E}")
    lines.append(f" hardware (tile) flops    {s.hardware_flops:.6E}")
    if s.hardware_flops > 0:
        lines.append(f" tile packing efficiency   {s.total_flops / s.hardware_flops:.3f}")
    if s.max_memory_bytes:
        lines.append(
            f" max device memory        {s.max_memory_bytes / 1e9:.3f} GB"
        )
    if s.routes:
        lines.append(
            " product routes           "
            + ", ".join(f"{k} {v}" for k, v in sorted(s.routes.items()))
        )
    lines.append(f" stacks                   {s.num_stacks}")
    if s.num_stacks:
        lines.append(f" avg stack size           {s.total_stack_entries / s.num_stacks:.1f}")
    lines.append(f" {'m x n x k':<16} {'blocks':>12} {'flops':>14}")
    any_aggregated = False

    def _lbl(v: int) -> str:
        # negative labels mark aggregated "other" classes (mnk_statistics):
        # the magnitude is the count-weighted mean size of the tail
        nonlocal any_aggregated
        if v < 0:
            any_aggregated = True
            return f"~{-v}"
        return str(v)

    for (m, n, k), (cnt, fl) in sorted(s.by_mnk.items(), key=lambda kv: -kv[1][1]):
        mnk = f"{_lbl(m)}x{_lbl(n)}x{_lbl(k)}"
        lines.append(f" {mnk:<16} {cnt:>12} {fl:>14.4E}")
    if any_aggregated:
        lines.append(
            " (~s = classes beyond the top-8 distinct sizes aggregated;"
            " label is the mean size, flops are exact)"
        )
    if s.comm_msgs:
        lines.append(" device communication (collective, message-size bucket)")
        lines.append(f" {'kind':<14} {'size bucket':>14} {'messages':>10} {'bytes':>14}")
        for (kind, bucket), (cnt, tot) in sorted(s.comm_msgs.items()):
            lines.append(
                f" {kind:<14} {'10^' + str(bucket) + ' B':>14} {cnt:>10} {tot:>14.4E}"
            )
    text = "\n".join(lines)
    if out is not None:
        print(text, file=out)
    return text
