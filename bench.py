#!/usr/bin/env python
"""Benchmark entry: prints ONE JSON line
{"metric": ..., "value": N, "unit": "TFLOP/s", "vs_baseline": N, ...}.

The metric is square-QR fp32 TFLOP/s, by 2n²(m − n/3), of
``tileqr.qr_factor`` at N×N on one GPU. ``vs_baseline`` is the time of
``jnp.linalg.qr(mode="r")`` (cuSOLVER geqrf) on the same matrix and card
divided by tileqr's time. Both are compiled before they are timed; each
time is the best of TILEQR_BENCH_REPS warm runs waited for with
``block_until_ready``. The line also names the device as JAX reports it
and the card with its power limit, as ``nvidia-smi`` gives them.

Environment: TILEQR_BENCH_N (32768), TILEQR_BENCH_NB (256),
TILEQR_BENCH_METHOD (hr | hh), TILEQR_BENCH_PRECISION (highest),
TILEQR_BENCH_REPS (3). There is no CPU path and no smaller fallback size:
without a GPU, or on any failure, the script exits non-zero.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

N = int(os.environ.get("TILEQR_BENCH_N", "32768"))
NB = int(os.environ.get("TILEQR_BENCH_NB", "256"))
METHOD = os.environ.get("TILEQR_BENCH_METHOD", "hr")
PRECISION = os.environ.get("TILEQR_BENCH_PRECISION", "highest")
REPS = int(os.environ.get("TILEQR_BENCH_REPS", "3"))


def _require_gpu():
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX's default backend is "
                         f"{jax.default_backend()!r}")


def _bench(n):
    import jax
    import jax.numpy as jnp

    import tileqr
    from tileqr.bench.run import device_record, nvidia_smi, qr_flops
    from tileqr.utils.profiling import warm_time

    cfg = tileqr.QRConfig(nb=NB, square_method=METHOD, precision=PRECISION)
    a = jax.jit(lambda k: jax.random.normal(k, (n, n), jnp.float32))(jax.random.PRNGKey(0))
    _, t_ours, f = warm_time(lambda x: tileqr.qr_factor(x, cfg), a, reps=REPS)
    del f
    _, t_base, _ = warm_time(jax.jit(lambda x: jnp.linalg.qr(x, mode="r")), a, reps=REPS)
    return {
        "metric": f"tiled QR fp32 TFLOP/s @ {n}x{n} (nb={NB}, {PRECISION}, method={METHOD})",
        "value": round(qr_flops(n, n) / t_ours / 1e12, 3),
        "unit": "TFLOP/s",
        "vs_baseline": round(t_base / t_ours, 3),
        "ours_ms": round(t_ours * 1e3, 3),
        "baseline_ms": round(t_base * 1e3, 3),
        "device": device_record(),
        "card": nvidia_smi(),
    }


def main():
    _require_gpu()
    from tileqr.utils.cache import configure_compile_cache

    configure_compile_cache()
    print(json.dumps(_bench(N)), flush=True)


if __name__ == "__main__":
    main()
