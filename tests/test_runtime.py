"""Process-level behaviour: the compile-cache location, what importing the
library loads, and the card smoke run refusing to run without a GPU."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "/some/cache/dir"])
def test_compile_cache_dir(monkeypatch, env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is used and nothing is set in
    code; otherwise the cache is the fixed in-checkout ``.jax_cache``."""
    import jax

    from tileqr.utils import cache

    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    sentinel = "/unchanged"
    jax.config.update("jax_compilation_cache_dir", sentinel)
    try:
        if env_dir is None:
            monkeypatch.delenv(cache.ENV, raising=False)
            path = cache.configure_compile_cache()
            assert path == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
        else:
            monkeypatch.setenv(cache.ENV, env_dir)
            assert cache.configure_compile_cache() == env_dir
            assert jax.config.jax_compilation_cache_dir == sentinel
    finally:
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def _run(args, **kw):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120, **kw)


def test_import_loads_no_pallas():
    """The library is plain JAX: importing every module loads no Pallas
    frontend."""
    res = _run(["-c", (
        "import sys, tileqr, tileqr.api, tileqr.drivers.sharded, "
        "tileqr.drivers.sharded_hr, tileqr.bench.run, tileqr.bench.ops; "
        "print(sorted(m for m in sys.modules if 'pallas' in m))")])
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_chip_smoke_refuses_cpu():
    """chip_smoke.py on the CPU exits non-zero and prints no result line."""
    res = _run(["chip_smoke.py"])
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
