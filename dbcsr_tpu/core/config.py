"""Typed configuration system with environment overrides and provenance.

Analog of the reference's config/flag system
(``src/core/dbcsr_config.F:100-246``): every parameter is typed, carries a
Default/Environment/User provenance tag, and can be overridden by an
environment variable ``DBCSR_<NAME>`` read at library init.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Iterator, Optional

__all__ = [
    "Config",
    "get_config",
    "set_config",
    "reset_config",
    "print_config",
    "config_override",
    "config_fingerprint",
]

_PROVENANCE_DEFAULT = "D"
_PROVENANCE_ENV = "E"
_PROVENANCE_USER = "U"


@dataclasses.dataclass
class Config:
    """Global configuration (analog of ``dbcsr_config_type``).

    Parameters mirror the reference's knobs where they still make sense
    here (``src/core/dbcsr_config.F:152-183``); runtime knobs (pinned
    memory, stream priorities, ...) have no equivalent because XLA owns the
    device runtime.
    """

    # --- multiply engine -------------------------------------------------
    #: hardware tile edge of the tile stores and stack products (untuned
    #: for the H100, ROADMAP S2)
    tile_size: int = 128
    #: engine selection: "auto" | "dense" | "stack" | "xla" | "band" (see
    #: ``mm.engine.select_route``)
    mm_driver: str = "auto"
    #: band driver admission (auto mode): max W_a*W_b diagonal products,
    #: and how much padded band work (W_a*W_b*Mt tile products) may exceed
    #: the stack path's tile-triple count (untuned for the H100)
    band_max_products: int = 128
    band_flop_factor: float = 0.75
    #: tile-level occupancy above which the dense-panel path is used
    #: (analog of the reference's dense-path heuristic,
    #: src/mm/dbcsr_mm.F:771; untuned for the H100)
    dense_threshold: float = 0.30
    #: use on-the-fly per-row epsilon thresholds (eps/row_count)**2 like
    #: dbcsr_mm_cannon.F:1100-1113 (else a flat eps**2 block filter)
    per_row_eps: bool = True
    #: triple-survival rule for on-the-fly filtering: "sum" keeps a C block
    #: when the SUM of its contributions' norm products clears the
    #: threshold (cheap superset; post-filter prunes the rest); "exact"
    #: reproduces the reference rule — a C block survives iff ANY single
    #: triple has |a|^2*|b|^2 >= (eps/row_count)^2
    #: (dbcsr_mm_csr.F:260-280, dbcsr_mm_cannon.F:1042-1113)
    filter_mode: str = "sum"
    #: accumulate tile products in this dtype
    acc_dtype: str = "float32"
    #: matmul precision for f32 inputs: "default" | "high" | "highest"
    #: (on the GPU "default" is TF32, "highest" true f32)
    matmul_precision: str = "highest"
    #: number of 2.5D C-reduction layers (3rd mesh axis), 1 = off
    num_layers_3d: int = 1
    #: avoid recompilation by bucketing dynamic lengths to powers of two
    shape_bucketing: bool = True
    #: use the native (C++) planner when available
    use_native_planner: bool = True
    #: collect per-(m,n,k) block-class multiplication statistics (the
    #: reference's STATISTICS report; skipped for many-class workloads)
    collect_mnk_stats: bool = True
    #: Cannon: partition work at tile granularity (fast path; block
    #: distributions honored as their nearest tile-aligned form). Off =
    #: block-atomic element-granular packing (reference-exact placement).
    use_tiled_cannon: bool = True
    #: distributed algorithm: "auto" (Cannon on square grids, SUMMA
    #: otherwise — the reference's cannon-vs-3D driver choice), "cannon",
    #: "summa"
    mm_dist_algo: str = "auto"
    #: f64 compute path: "auto" (default) and "native" use the native
    #: f64 dot everywhere — on the H100 the FP64 tensor cores; the banded
    #: 400,000-row f64 stack ran there in 38.8 ms, while the ozaki slice
    #: scheme's stack product asked for 164 GiB and could not run
    #: (PERF.md). "ozaki" forces the exact bf16 slice schemes
    #: (ops/f64_emu.py).
    f64_method: str = "auto"
    #: mantissa slices for the ozaki paths. 0 = auto: each path's full-
    #: f64 default (dense ``ozaki_matmul``: 7 x 8-bit slices; stack
    #: ``tile_stack_matmul_ozaki``: 8 x 7-bit slices — the narrower
    #: slices let whole anti-diagonal pair groups accumulate EXACTLY in
    #: f32, see ops/f64_emu.py). An explicit N trades accuracy for matrix
    #: passes (error ~2^-bits*(N-1) relative, x condition number).
    f64_slices: int = 0
    #: use communication-optimal splitting in TAS multiplies
    tas_split_factor: float = 1.0
    #: randomly seeded value used by random matrix generators
    default_seed: int = 0

    # provenance bookkeeping: name -> D/E/U
    _provenance: Dict[str, str] = dataclasses.field(
        default_factory=dict, repr=False
    )

    def provenance(self, name: str) -> str:
        return self._provenance.get(name, _PROVENANCE_DEFAULT)

    def params(self) -> Iterator[str]:
        for f in dataclasses.fields(self):
            if not f.name.startswith("_"):
                yield f.name


_cfg: Optional[Config] = None


def _coerce(value: str, like: Any) -> Any:
    if isinstance(like, bool):
        return value.strip().lower() in ("1", "true", "t", "yes", "on")
    if isinstance(like, int):
        return int(value)
    if isinstance(like, float):
        return float(value)
    return value


def _load_env(cfg: Config) -> None:
    """Read ``DBCSR_<NAME>`` env vars (reference: dbcsr_config.F:214-246)."""
    for name in cfg.params():
        env = os.environ.get("DBCSR_" + name.upper())
        if env is not None:
            setattr(cfg, name, _coerce(env, getattr(cfg, name)))
            cfg._provenance[name] = _PROVENANCE_ENV


def get_config() -> Config:
    global _cfg
    if _cfg is None:
        _cfg = Config()
        _load_env(_cfg)
    return _cfg


def config_fingerprint(cfg: Optional[Config] = None) -> str:
    """Stable fingerprint of the public config fields AND their D/E/U
    provenance, for plan/executor cache keys.

    Values alone are not enough: a default-provenance ``mm_driver`` defers
    to the tuned table at plan time (``mm/engine.py:_tuned_driver``), so
    a config where ``mm_driver="auto"`` by DEFAULT can resolve a different
    plan than one where the user PINNED it. The ``_provenance`` dict
    itself must not be embedded raw — its repr depends on mutation order —
    so fields are emitted in declaration order with their provenance
    letters."""
    if cfg is None:
        cfg = get_config()
    return repr(
        [(n, getattr(cfg, n), cfg.provenance(n)) for n in cfg.params()]
    )


def set_config(**kwargs: Any) -> None:
    """User-level override (analog of ``dbcsr_set_config``)."""
    cfg = get_config()
    for name, value in kwargs.items():
        if name not in set(cfg.params()):
            raise KeyError(f"unknown config parameter: {name!r}")
        setattr(cfg, name, value)
        cfg._provenance[name] = _PROVENANCE_USER


def reset_config() -> None:
    global _cfg
    _cfg = None


class config_override:
    """Context manager for scoped config changes (handy in tests)."""

    def __init__(self, **kwargs: Any):
        self._kwargs = kwargs
        self._saved: Dict[str, Any] = {}

    def __enter__(self) -> Config:
        cfg = get_config()
        for name, value in self._kwargs.items():
            self._saved[name] = (getattr(cfg, name), cfg.provenance(name))
        set_config(**self._kwargs)
        return cfg

    def __exit__(self, *exc: Any) -> None:
        cfg = get_config()
        for name, (value, prov) in self._saved.items():
            setattr(cfg, name, value)
            cfg._provenance[name] = prov


def print_config(out=None) -> str:
    """Render the provenance-tagged parameter table
    (analog of ``dbcsr_print_config``)."""
    cfg = get_config()
    lines = [f"{'parameter':<24} {'value':<16} src"]
    for name in cfg.params():
        lines.append(f"{name:<24} {getattr(cfg, name)!s:<16} {cfg.provenance(name)}")
    text = "\n".join(lines)
    if out is not None:
        print(text, file=out)
    return text
