"""Shared bootstrap for tools/ scripts run as ``python tools/<x>.py``.

The package is not pip-installed and Python puts the SCRIPT's directory
(tools/), not the cwd, on sys.path — so the repo root is inserted for
``import dbcsr_tpu`` to resolve. The backend follows ``JAX_PLATFORMS``.

Usage (first import in the tool, before dbcsr_tpu/jax usage):

    import _bootstrap  # noqa: F401
"""
import os
import sys

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
)
