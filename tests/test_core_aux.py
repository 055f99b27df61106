"""Core auxiliary subsystems: machine metrics, logging, config, timers."""
import io

import numpy as np
import pytest

import dbcsr_tpu as dt
from dbcsr_tpu.core import (
    Logger,
    get_logger,
    m_memory,
    m_peak_memory,
    m_walltime,
    pop_logger,
    push_logger,
)
from dbcsr_tpu.core.config import config_override, get_config, print_config
from dbcsr_tpu.core.logging import LOG_DEBUG, LOG_NOTE
from dbcsr_tpu.core.timing import reset_timers, timed, timer_report


def test_machine_metrics():
    t0 = m_walltime()
    assert m_walltime() >= t0
    mem = m_memory()
    assert mem > 1024 * 1024  # this process surely uses >1MB
    assert m_peak_memory() >= mem * 0.5


def test_logger_levels_and_stack():
    buf = io.StringIO()
    lg = Logger(stream=buf, level=LOG_NOTE, prefix="t")
    push_logger(lg)
    try:
        assert get_logger() is lg
        lg.note("hello")
        lg.debug("invisible")
        lg.error("bad")
    finally:
        pop_logger()
    out = buf.getvalue()
    assert "hello" in out and "bad" in out and "invisible" not in out
    assert "[t:NOTE]" in out


def test_config_env_and_provenance(monkeypatch):
    from dbcsr_tpu.core.config import reset_config

    monkeypatch.setenv("DBCSR_BAND_MAX_PRODUCTS", "12345")
    reset_config()
    try:
        cfg = get_config()
        assert cfg.band_max_products == 12345
        assert cfg.provenance("band_max_products") == "E"
        table = print_config()
        assert "band_max_products" in table and "12345" in table
    finally:
        monkeypatch.delenv("DBCSR_BAND_MAX_PRODUCTS")
        reset_config()


def test_timer_report_contains_nested():
    reset_timers()
    with timed("outer"):
        with timed("outer/inner"):
            pass
    rep = timer_report()
    assert "outer" in rep and "outer/inner" in rep


def test_callgraph_export(tmp_path):
    from dbcsr_tpu.core.timing import timings_report_callgraph

    reset_timers()
    with timed("top"):
        for _ in range(3):
            with timed("child"):
                pass
    path = str(tmp_path / "cg.out")
    timings_report_callgraph(path)
    text = open(path).read()
    assert "events: Walltime_us" in text
    assert "fn=top" in text and "cfn=child" in text and "calls=3 1" in text


def test_statistics_report(rng):
    from dbcsr_tpu.core.stats import reset_stats

    reset_stats()
    bs = dt.random_block_sizes(30, [2, 3], rng)
    a = dt.random_matrix(bs, bs, 0.4, rng, dtype=np.float64)
    b = dt.random_matrix(bs, bs, 0.4, rng, dtype=np.float64)
    dt.multiply("N", "N", 1.0, a, b)
    rep = dt.print_statistics()
    assert "multiplications" in rep
    assert "effective flops" in rep
    # per-(m,n,k) classes recorded (2/3-sized blocks -> classes like 2x2x3)
    assert "x" in rep.splitlines()[-1]
