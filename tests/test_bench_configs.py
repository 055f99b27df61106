"""Smoke every bench.py config end-to-end in TINY mode.

bench.py measures on the GPU; a bug there would cost a chip run its
numbers. Each config runs ~20x-shrunk on CPU (``DBCSR_BENCH_TINY=1`` +
``JAX_PLATFORMS=cpu``) through the code path the GPU run
uses, and must print one valid JSON record with the bench's schema.
Reference analog: the perf driver is itself a tested executable
(``/root/reference/tests/CMakeLists.txt`` registers dbcsr_perf inputs).
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIGS = [
    "block23", "sparse5", "mixed", "banded", "clustered", "filtered",
    "tensor",
]


@pytest.mark.parametrize("config", CONFIGS)
def test_bench_config_tiny(config):
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", DBCSR_BENCH_TINY="1")
    # the bench must not inherit the suite's virtual-device XLA_FLAGS
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), config],
        env=env, capture_output=True, text=True, timeout=560, cwd=REPO,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    line = res.stdout.strip().splitlines()[-1]
    rec = json.loads(line)
    for key in ("metric", "value", "unit", "vs_baseline"):
        assert key in rec, rec
    assert "skipped" not in rec, rec
    assert rec["unit"] == "GFLOP/s"
    assert rec["value"] > 0.0
    # every record names its device and precision; TINY runs say so
    assert rec["platform"] == "cpu" and rec["tiny"] is True
    assert rec["device_count"] >= 1 and rec["device_kind"]
    assert rec["matmul_precision"] == "default"
    if config not in ("filtered", "tensor"):
        assert rec["block_matmuls_per_s"] > 0
