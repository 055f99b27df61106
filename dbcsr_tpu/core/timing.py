"""Call-stack timer environment + report.

Analog of the reference's timing framework
(``src/core/dbcsr_timings.F:65-416``, report ``dbcsr_timings_report.F``):
``timeset``/``timestop`` pairs maintain a per-thread call stack with
inclusive/exclusive times and per-routine statistics; ranges are forwarded
to ``jax.profiler`` trace annotations (the NVTX/rocTX analog,
``src/acc/cuda/dbcsr_cuda_nvtx_cu.cpp``) so they show up in xprof traces.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

__all__ = [
    "timeset",
    "timestop",
    "timed",
    "timer_report",
    "timings_report_callgraph",
    "set_tracing",
    "reset_timers",
    "RoutineStat",
]

try:  # trace annotations are best-effort; profiling may be unavailable
    from jax.profiler import TraceAnnotation as _TraceAnnotation
except Exception:  # pragma: no cover
    _TraceAnnotation = None


@dataclass
class RoutineStat:
    calls: int = 0
    total_time: float = 0.0  # inclusive
    self_time: float = 0.0  # exclusive
    max_total: float = 0.0


@dataclass
class _Frame:
    name: str
    t0: float
    child_time: float = 0.0
    annotation: object = None


class _TimerEnv(threading.local):
    def __init__(self) -> None:
        self.stack: List[_Frame] = []
        self.stats: Dict[str, RoutineStat] = {}
        self.edges: Dict[tuple, List[float]] = {}  # (caller, callee) -> [calls, time]


_env = _TimerEnv()
_tracing: bool = True  # process-wide, like the reference's toggle


def timeset(name: str) -> None:
    frame = _Frame(name, time.perf_counter())
    if _tracing and _TraceAnnotation is not None:
        try:
            frame.annotation = _TraceAnnotation(name)
            frame.annotation.__enter__()
        except Exception:
            frame.annotation = None
    _env.stack.append(frame)


def timestop(name: Optional[str] = None) -> None:
    frame = _env.stack.pop()
    if name is not None and frame.name != name:
        raise RuntimeError(f"timer mismatch: stopped {name!r}, top was {frame.name!r}")
    if frame.annotation is not None:
        frame.annotation.__exit__(None, None, None)
    dt = time.perf_counter() - frame.t0
    st = _env.stats.setdefault(frame.name, RoutineStat())
    st.calls += 1
    st.total_time += dt
    st.self_time += dt - frame.child_time
    st.max_total = max(st.max_total, dt)
    if _env.stack:
        _env.stack[-1].child_time += dt
        edge = _env.edges.setdefault(
            (_env.stack[-1].name, frame.name), [0, 0.0]
        )
        edge[0] += 1
        edge[1] += dt


@contextmanager
def timed(name: str) -> Iterator[None]:
    timeset(name)
    try:
        yield
    finally:
        timestop(name)


def set_tracing(enabled: bool) -> None:
    """Toggle jax.profiler trace annotations for timed ranges,
    process-wide (the reference's ``timings_setup_tracing``,
    ``src/core/dbcsr_timings_report.F:357``)."""
    global _tracing
    _tracing = bool(enabled)


def reset_timers() -> None:
    _env.stats.clear()
    _env.stack.clear()
    _env.edges.clear()


def timer_stats() -> Dict[str, RoutineStat]:
    return dict(_env.stats)


def timer_report(out=None, max_rows: int = 40) -> str:
    """Per-routine table sorted by self time (analog of the reference's
    MPI-reduced timing report; single-process here — collect per-host and
    reduce externally for multi-host runs)."""
    rows = sorted(_env.stats.items(), key=lambda kv: -kv[1].self_time)[:max_rows]
    lines = [f"{'routine':<44} {'calls':>7} {'self[s]':>10} {'total[s]':>10} {'max[s]':>10}"]
    for name, st in rows:
        lines.append(
            f"{name:<44} {st.calls:>7} {st.self_time:>10.4f} {st.total_time:>10.4f} {st.max_total:>10.4f}"
        )
    text = "\n".join(lines)
    if out is not None:
        print(text, file=out)
    return text


def timings_report_callgraph(path: str) -> None:
    """Dump the timer call graph in callgrind format for kcachegrind
    (``timings_report_callgraph``, ``src/core/dbcsr_timings_report.F:303``).
    Costs are microseconds of walltime; edges carry call counts and
    inclusive times."""
    with open(path, "w") as f:
        f.write("# callgrind format — dbcsr_tpu timer callgraph\n")
        f.write("events: Walltime_us\n\n")
        for name, st in sorted(_env.stats.items()):
            f.write(f"fn={name}\n")
            f.write(f"1 {max(int(st.self_time * 1e6), 0)}\n")
            for (caller, callee), (calls, t) in sorted(_env.edges.items()):
                if caller != name:
                    continue
                f.write(f"cfn={callee}\n")
                f.write(f"calls={int(calls)} 1\n")
                f.write(f"1 {max(int(t * 1e6), 0)}\n")
            f.write("\n")
