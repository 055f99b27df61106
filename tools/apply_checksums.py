"""Pin the checksum references of the .perf recipes from a numpy f64 oracle.

For each recipe this builds the seeded operands exactly as
``python -m dbcsr_tpu.perf`` does (``perf.make_operands``), forms the
result as a dense numpy f64 product on the host (``perf.oracle_dense``)
and writes its position-weighted checksum into the recipe's
``# checksum`` block (``T`` + threshold + reference). No device
arithmetic enters the reference. Reference analog: the ``checksum_ref``
lines in the reference's ``tests/inputs/*.perf``
(``tests/dbcsr_performance_multiply.F:102``).

Usage: JAX_PLATFORMS=cpu python tools/apply_checksums.py [recipe ...]
       [--dry-run]
"""
import _bootstrap  # noqa: F401  (repo-root sys.path)
import glob
import os
import re
import sys

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
INPUTS = os.path.join(REPO, "tests", "inputs")

#: relative tolerance of the check: an f64 device product differs from
#: the host oracle only in summation order (~1e-15 per element)
THRESHOLD = 1e-10

HEADER = (
    "# checksum (position-weighted pd_blk_cs form of the numpy f64\n"
    "#  oracle of the seeded operands, tools/apply_checksums.py)\n"
)


def oracle_checksum(path: str, seed: int = 0) -> float:
    from dbcsr_tpu.perf import (
        dense_checksum,
        make_operands,
        oracle_dense,
        parse_perf,
    )

    cfg = parse_perf(path)
    return dense_checksum(oracle_dense(cfg, make_operands(cfg, seed)))


def apply_to_recipe(path: str, ref: float, threshold: float = THRESHOLD,
                    dry_run: bool = False) -> bool:
    """Rewrite the recipe's checksum block (the last section of the
    format: '# checksum' comment lines, then F or T/threshold/refs)."""
    with open(path) as f:
        text = f.read()
    m = re.search(r"# checksum[^\n]*\n(?:#[^\n]*\n)*", text)
    if not m:
        print(f"  {os.path.basename(path)}: no '# checksum' block found")
        return False
    new = text[: m.start()] + HEADER + f"T\n{threshold:.1E}\n{ref:.15E}\n"
    if dry_run:
        print(f"  would pin {os.path.basename(path)}: ref {ref:.15E}")
        return True
    with open(path, "w") as f:
        f.write(new)
    print(f"  pinned {os.path.basename(path)}: ref {ref:.15E}")
    return True


def main(argv=None) -> int:
    import dbcsr_tpu as dt

    argv = argv if argv is not None else sys.argv[1:]
    dry = "--dry-run" in argv
    paths = [a for a in argv if a != "--dry-run"] or sorted(
        glob.glob(os.path.join(INPUTS, "*.perf"))
    )
    dt.init_lib()
    n_ok = sum(
        apply_to_recipe(p, oracle_checksum(p), dry_run=dry) for p in paths
    )
    print(f"{n_ok}/{len(paths)} recipes {'would be ' if dry else ''}pinned")
    return 0 if n_ok == len(paths) else 1


if __name__ == "__main__":
    raise SystemExit(main())
