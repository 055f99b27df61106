"""Kernel self-validation and the built-in self-tests.

``test_validate_kernels_on_chip`` needs the card (marker ``gpu``): every
hand-written kernel compiled for the GPU against its XLA reference. Run it
with ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``. The reference's
analog is its JIT-time kernel self-validation
(``src/acc/libsmm_acc/libsmm_acc.cpp:55-89``). The other tests run on any
backend.
"""
import pytest

import dbcsr_tpu as dt


@pytest.mark.gpu
def test_validate_kernels_on_chip():
    """Every hand-written kernel against its XLA reference, compiled."""
    assert dt.testing.validate_kernels(verbose=True)


def test_validate_kernels_interpret():
    """The same validation off the card runs the kernels in interpret
    mode (the CPU rehearsal of the on-chip check)."""
    assert dt.testing.validate_kernels(tile=32, verbose=True)


def test_builtin_selftest_mm():
    """The embedded self-test sweep's multiply leg (runs on any backend;
    on the card it exercises the production dispatch end to end)."""
    assert dt.testing.test_mm(
        nblkrows=24, nblkcols=20, nblkks=22, occupancy=0.4, seed=3
    )


def test_ozaki_f64_numerics():
    """True-f64 ozaki slice product vs a host f64 oracle (the slice
    scheme stays reachable with ``f64_method="ozaki"``)."""
    import numpy as np
    import jax.numpy as jnp

    from dbcsr_tpu.ops.f64_emu import ozaki_matmul

    rng = np.random.default_rng(11)
    a = rng.standard_normal((96, 260)) * np.exp2(
        rng.integers(-20, 20, (96, 1)).astype(np.float64)
    )
    b = rng.standard_normal((260, 72))
    ref = a @ b
    got = np.asarray(ozaki_matmul(jnp.asarray(a), jnp.asarray(b)))
    bound = np.abs(a) @ np.abs(b)
    assert np.max(np.abs(got - ref) / bound) < 1e-13
