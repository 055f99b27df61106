"""The migration-story examples are validated artifacts, not prose.

``examples/example_9_reference_example_3.py`` and
``example_10_reference_tensor_example_2.py`` port the reference's two
worked C-API examples (``/root/reference/examples/dbcsr_example_3.cpp``,
``dbcsr_tensor_example_2.cpp``) with the original block sizes, non-zero
lists and scaling factors, and assert against dense oracles internally.
Running them in the suite keeps the migration documentation correct by
construction (SURVEY §1 layer 13).
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MIGRATION_EXAMPLES = [
    "example_9_reference_example_3.py",
    "example_10_reference_tensor_example_2.py",
]


@pytest.mark.parametrize("script", MIGRATION_EXAMPLES)
def test_migration_example(script):
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
    )
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", script)],
        env=env, capture_output=True, text=True, timeout=560, cwd=REPO,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "OK — reference" in res.stdout
