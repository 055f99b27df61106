"""chip_smoke.py and the measurement helpers around it: the CPU rehearsal
(``--tiny``), the refusal to run without a GPU, the peak table, the
compile-cache helper, and each phase's oracle checker fed one corrupted
block."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import dbcsr_tpu as dt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import chip_smoke  # noqa: E402


def _run(args, **env):
    e = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    e.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), *args],
        env=e, capture_output=True, text=True, timeout=560, cwd=REPO,
    )


def test_chip_smoke_tiny_rehearsal(tmp_path):
    res = _run(["--tiny"], JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    last = json.loads(lines[-1])
    assert last == {"ok": True, "device": {
        "platform": "cpu", "kind": "cpu", "count": 1}}
    phases = [json.loads(ln)["phase"] for ln in lines if ln.startswith("{")
              and "phase" in ln]
    assert phases == ["device", "h2o", "banded", "banded", "banded",
                      "filtered", "tensor", "kernels"]
    for ln in lines:
        if ln.startswith('{"phase"'):
            rec = json.loads(ln)
            if rec["phase"] != "device":
                assert rec["err"] <= rec["tol"], rec
                for key in ("dtype", "precision", "seconds"):
                    assert key in rec, rec


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """Without --tiny the script needs a GPU: on the CPU it exits non-zero
    and prints no result line."""
    res = _run([], JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "no GPU" in res.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding only the script, the import of the library
    fails and nothing is printed as a result."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    e = dict(os.environ, JAX_PLATFORMS="cpu")
    e.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "chip_smoke.py", "--tiny"], cwd=tmp_path, env=e,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0 and '"ok"' not in res.stdout


def test_peak_table_knows_the_h100_and_nothing_else():
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["tf32_flops"] == 495e12 and peaks["bf16_flops"] == 989e12
    assert peaks["hbm_bytes_per_s"] == 3.35e12
    for kind in ("cpu", "Quadro RTX 6000", "NVIDIA A100-SXM4-80GB"):
        with pytest.raises(KeyError):
            bench.device_peaks(kind)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    import jax

    from dbcsr_tpu.core import machine

    old = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
    try:
        assert machine.setup_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def _corrupt(store, slot, value=1.0):
    """Add ``value`` at element (0, 0) of tile ``slot``."""
    return store.at[slot, 0, 0].add(value)


def _corrupt_block(m, value):
    """``m`` with ``value`` added inside its first stored block, at local
    element (1, 2) (global weight log((r+2)(c+3)) > 0)."""
    ix, t = m.index, m.tile
    r = int(ix.row_offsets[ix.blk_rows[0]]) + 1
    c = int(ix.col_offsets[ix.col_idx[0]]) + 2
    slot = int(np.searchsorted(m.layout.tile_keys(),
                               (r // t) * m.layout.ntc + c // t))
    return m.with_data(m.data.at[slot, r % t, c % t].add(value))


def test_h2o_oracle_catches_a_corrupted_block():
    from dbcsr_tpu.perf import (
        dense_checksum, dense_host, make_operands, oracle_dense, parse_perf,
    )

    cfg = parse_perf(os.path.join(REPO, "tests", "inputs", "H2O.perf"))
    cfg.m = cfg.n = cfg.k = 92
    ops = make_operands(cfg, 0)
    out = dt.multiply("N", "N", ops["alpha"], ops["a"], ops["b"],
                      ops["beta"], ops["c"])
    ref = oracle_dense(cfg, ops)
    tol = chip_smoke.TOLERANCES["float64"]
    assert chip_smoke.rel_err(dense_host(out), ref) <= tol
    bad = _corrupt_block(out, 1e-3)
    assert chip_smoke.rel_err(dense_host(bad), ref) > tol
    assert dense_checksum(dense_host(bad)) != pytest.approx(
        dense_checksum(ref), rel=1e-10
    )


def test_banded_oracle_catches_a_corrupted_block():
    import jax.numpy as jnp

    from dbcsr_tpu.mm.engine import build_multiply_executor

    a, b = chip_smoke.banded_pair(1000, jnp.float64, 3)
    fn, c_index, _ = build_multiply_executor("N", "N", a, b)
    c = fn(a.data, b.data)
    rows = chip_smoke.sample_rows(a.index.nblkrows, 256, 3)
    assert len(rows) == a.index.nblkrows  # every row sampled
    tol = chip_smoke.TOLERANCES["float64"]
    assert chip_smoke.banded_oracle(a, b, c, c_index, rows) <= tol
    from dbcsr_tpu.block.store import store_layout

    lay = store_layout(c_index, a.tile)
    tr = lay.ntr // 2  # a diagonal tile: its (0, 0) is inside the band
    slot = int(np.searchsorted(lay.tile_keys(), tr * lay.ntc + tr))
    bad = _corrupt(c, slot, 1e-6 * float(jnp.max(jnp.abs(c))))
    assert chip_smoke.banded_oracle(a, b, bad, c_index, rows) > tol


def test_sample_rows_keeps_first_and_last():
    rows = chip_smoke.sample_rows(10_000, 256, 0)
    assert len(rows) == 256 and rows[0] == 0 and rows[-1] == 9_999
    assert len(np.unique(rows)) == 256


def test_filtered_check_catches_a_corrupted_block():
    import jax.numpy as jnp

    from dbcsr_tpu.mm.engine import build_multiply_executor

    eps = 1e-6
    a, b = chip_smoke.banded_pair(1000, jnp.float64, 5, decay=True)
    fn, idx, _ = build_multiply_executor("N", "N", a, b)
    full = dt.BCSRMatrix(name="C", index=idx, data=fn(a.data, b.data))
    ex = dt.build_filtered_executor("N", "N", a, b, eps)
    c, keep, _ = ex.step(a.data, b.data)
    kept = ex.compact(c, keep)
    err, worst, n_kept, n_dropped = chip_smoke.filtered_errors(
        full, kept.index, kept.data
    )
    assert err == 0.0 and worst < eps and n_kept and n_dropped
    bad = _corrupt(kept.data, 0, 1e-3)
    assert chip_smoke.filtered_errors(full, kept.index, bad)[0] > 1e-11
    # a filter that dropped a large block breaks the threshold rule
    big = int(np.argmax(dt.block_norms(full)))
    rows = np.delete(full.index.blk_rows, big)
    cols = np.delete(full.index.col_idx, big)
    from dbcsr_tpu.block.index import build_index

    sub, _ = build_index(rows.astype(np.int64), cols.astype(np.int64),
                         full.index.row_block_sizes,
                         full.index.col_block_sizes)
    sub_m = dt.BCSRMatrix.from_flat(
        sub, dt.BCSRMatrix(name="x", index=idx, data=full.data).flat_host()[
            np.concatenate([
                np.arange(full.index.blk_offset[k],
                          full.index.blk_offset[k + 1])
                for k in range(full.nblks) if k != big
            ])
        ], tile=full.tile,
    )
    assert chip_smoke.filtered_errors(full, sub_m.index, sub_m.data)[1] > eps


def test_tensor_oracle_catches_a_corrupted_element():
    a, b, kw = chip_smoke.tensor_operands(True, 0)
    got = np.asarray(dt.contract(1.0, a, b, **kw).to_dense())
    ref = np.einsum("ijk,kl->ijl", np.asarray(a.to_dense()),
                    np.asarray(b.to_dense()))
    tol = chip_smoke.TOLERANCES["float64"]
    assert chip_smoke.rel_err(got, ref) <= tol
    got[3, 2, 1] += 1e-3
    assert chip_smoke.rel_err(got, ref) > tol
