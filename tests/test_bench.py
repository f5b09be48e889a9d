"""Bench harness smoke tests (component C11, SURVEY.md §2.1).

Round-1 lesson: the advertised ``--check`` path crashed after a driver
refactor because nothing exercised it. These CPU-backend smokes pin every
bench entry point, check flag included, to a finite result.
"""

import math

import pytest

from tileqr.bench.run import bench_batched, bench_jnp_qr, bench_square, bench_tsqr


@pytest.mark.parametrize(
    "method,driver",
    [("hh", "static"), ("hh", "loop"), ("hr", "static"), ("hr", "chunked")],
)
def test_bench_square_check(method, driver, monkeypatch):
    """Every shipping square path is one harness call (VERDICT r3 weak-#2),
    each with the full-width streamed relerr."""
    from tileqr.drivers import square

    if driver in ("chunked", "loop"):
        # the segmented hr driver / the hh loop driver at the smallest
        # geometry
        monkeypatch.setattr(square, "STATIC_MAX_PANELS", 1)
    # 128×128 at nb=64: 2 panels — the minimal geometry that exercises
    # every driver's panel loop
    rec = bench_square(128, 64, "highest", chain=2, check=True, method=method)
    assert rec["bench"] == "qr_square"
    assert rec["method"] == method
    assert rec["segmented"] == (driver != "static")
    assert rec["ms"] > 0 and rec["tflops"] > 0
    assert math.isfinite(rec["relerr"])
    assert rec["relerr"] < 1e-5


def test_bench_square_rejects_bad_combo():
    with pytest.raises(SystemExit):
        bench_square(100, 64, "highest", chain=2, check=False, method="hr")


@pytest.mark.parametrize("strategy", ["tree", "chain", "cholqr2"])
def test_bench_tsqr(strategy):
    # smallest geometry with real leaf/combine + chain-couple structure
    # (128×32, nb=64): the test pins the CLI plumbing + a finite checked
    # record, not perf — shrunk from 256×64/nb=128 (r5 fast-suite budget,
    # 41 s → ~12 s across the three params)
    rec = bench_tsqr(128, 32, 64, chain=2, strategy=strategy, check=True)
    assert rec["strategy"] == strategy
    assert rec["ms"] > 0 and rec["tflops"] > 0
    assert rec["relerr_r"] < 1e-5


def test_bench_batched_check():
    rec = bench_batched(8, 32, chain=2, check=True)
    assert rec["kernel"] == "hh"
    assert rec["ms"] > 0
    assert rec["relerr_max"] < 1e-5


def test_bench_baseline():
    rec = bench_jnp_qr(128, chain=2)
    assert rec["ms"] > 0


def test_root_bench_contract_size_fallback(monkeypatch, capsys):
    """bench.py has no fallback: without a GPU it exits non-zero before it
    measures anything, and a failure at the contract size (32768²)
    propagates instead of retrying at a smaller size."""
    import importlib
    import os
    import sys as _sys

    import jax

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _sys.path.insert(0, repo)
    cache_dir = jax.config.jax_compilation_cache_dir
    bench = importlib.import_module("bench")
    # importing bench must not touch the suite's compile-cache settings
    assert jax.config.jax_compilation_cache_dir == cache_dir
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code != 0
    assert capsys.readouterr().out == ""

    calls = []

    def fails(n):
        calls.append(n)
        raise RuntimeError("RESOURCE_EXHAUSTED (simulated)")

    import tileqr.utils.cache

    monkeypatch.setattr(bench, "_require_gpu", lambda: None)
    monkeypatch.setattr(tileqr.utils.cache, "configure_compile_cache", lambda: None)
    monkeypatch.setattr(bench, "_bench", fails)
    monkeypatch.setattr(bench, "N", 32768)
    with pytest.raises(RuntimeError):
        bench.main()
    assert calls == [32768]
    assert capsys.readouterr().out == ""
