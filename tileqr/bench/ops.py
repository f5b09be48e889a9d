"""Per-op alternatives and driver sweeps on the GPU (the PERF.md tables).

Each line of output is one JSON record naming the op, the variant, the
shape, the first-call seconds (compilation included), the best warm
milliseconds and a correctness figure. The device and the card's power
limit head the output.

  python -m tileqr.bench.ops [--only modlu,tsqr,chunk,driver]
      [--out ops.jsonl]

Groups:
  modlu    modified LU at 256 for several loop unrolls, and the 8192² hr
           factorization with the default
  tsqr     TSQR leaf heights at 1048576×512, and the chain and cholqr2
           strategies
  chunk    couple height {1, 4, whole panel} of the hh driver at 4096²,
           with the full-width residual
  driver   the unrolled hh driver against the loop driver at 16384²
           (64 panels): first call (compilation included) and warm time
(The hh and hr compile at 64 and 128 panels through the api is
chip_smoke.py's set-up time at 16384² and 32768².)

The earlier groups that decided the forms PERF.md records (modified LU's
recursive form, the Pallas and recursive POTRFs, the vectorized batched
loop, leaves of 2048–8192 rows) measured code that was removed after it
lost; their records stay in PERF.md only.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from tileqr.bench.run import device_record, nvidia_smi, qr_flops
from tileqr.utils.profiling import warm_time

GROUPS = ("modlu", "tsqr", "chunk", "driver")


def _emit(out, rec):
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        out.write(line + "\n")
        out.flush()


def _rec(op, variant, shape, first, best, **extra):
    return {"op": op, "variant": variant, "shape": list(shape),
            "first_s": round(first, 4), "ms": round(best * 1e3, 4), **extra}


def _orth_top(n, seed=0):
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((2 * n, n)))
    return jnp.asarray(q[:n], jnp.float32)


def group_modlu(out, nb=256, unrolls=(1, 4, 8, 16, 32), n=8192):
    from tileqr.drivers import square_hr
    from tileqr.kernels import modlu

    q = _orth_top(nb)
    for u in unrolls:
        first, best, (lu, d) = warm_time(lambda x, u=u: modlu.modified_lu(x, unroll=u), q, reps=5)
        lu = np.asarray(lu, np.float64)
        L = np.tril(lu, -1) + np.eye(nb)
        U = np.triu(lu)
        err = float(np.abs(L @ U - (np.asarray(q, np.float64) - np.diag(np.asarray(d)))).max())
        _emit(out, _rec("modlu", f"unroll={u}", (nb, nb), first, best, max_err=err))
    # inside the factorization: every panel inlines its own copy
    a = jax.random.normal(jax.random.PRNGKey(0), (n, n), jnp.float32)
    run = jax.jit(lambda x: square_hr.qr_hr.__wrapped__(x, nb))
    first, best, _ = warm_time(run, a, reps=2)
    _emit(out, _rec("qr_hr", f"unroll={modlu.UNROLL}", a.shape, first, best,
                    tflops=qr_flops(n, n) / best / 1e12))


def group_tsqr(out, m=1048576, n=512, leaves=(16384, 65536, 131072, 262144)):
    import tileqr
    from tileqr.drivers.tsqr import tsqr_factor

    a = jax.random.normal(jax.random.PRNGKey(4), (m, n), jnp.float32)
    r_ref = None
    for lr in leaves:
        run = jax.jit(lambda x, lr=lr: tsqr_factor(x, n, leaf_rows=lr).r)
        first, best, r = warm_time(run, a, reps=3)
        if r_ref is None:
            r_ref = np.abs(np.asarray(r, np.float64))
        dev = float(np.linalg.norm(np.abs(np.asarray(r, np.float64)) - r_ref)
                    / np.linalg.norm(r_ref))
        _emit(out, _rec("tsqr_tree", f"leaf_rows={lr}", (m, n), first, best,
                        r_dev_vs_first=dev, tflops=qr_flops(m, n) / best / 1e12))
    cfg = tileqr.QRConfig(nb=n, hr_guard="off")
    for strategy in ("chain", "cholqr2"):
        run = jax.jit(lambda x, s=strategy: tileqr.tsqr(x, mode="r", config=cfg, strategy=s))
        first, best, _ = warm_time(run, a, reps=3)
        _emit(out, _rec("tsqr", strategy, (m, n), first, best,
                        tflops=qr_flops(m, n) / best / 1e12))
    first, best, _ = warm_time(jax.jit(lambda x: jnp.linalg.qr(x, mode="r")), a, reps=3)
    _emit(out, _rec("tsqr", "jnp.linalg.qr", (m, n), first, best))


def group_chunk(out, nb=256, plan=((4096, (1, 4, 0)),)):
    from tileqr.drivers.square import apply_q_tiled, assemble_r, qr_tiled
    from tileqr.utils.verify import relerr_streamed

    for n, chunks in plan:
        a = jax.random.normal(jax.random.PRNGKey(5), (n, n), jnp.float32)
        for chunk in chunks:
            run = jax.jit(lambda x, c=chunk: qr_tiled(x, nb, chunk=c))
            first, best, (packed, r_diag, t_g, panels) = warm_time(run, a, reps=2)
            relerr = relerr_streamed(
                lambda c: apply_q_tiled(panels, t_g, c, nb, trans=True), a,
                assemble_r(packed, r_diag, nb), col_block=1024)
            _emit(out, _rec("qr_tiled", f"chunk={chunk}", (n, n), first, best,
                            tflops=qr_flops(n, n) / best / 1e12, relerr=relerr))
            del packed, r_diag, t_g, panels
        del a


def group_driver(out, nb=256, n=16384):
    from tileqr.drivers import square

    a = jax.random.normal(jax.random.PRNGKey(5), (n, n), jnp.float32)
    runs = (("static", jax.jit(lambda x: square.qr_tiled(x, nb))),
            ("loop", functools.partial(square.qr_tiled_loop, nb=nb)))
    for name, run in runs:
        first, best, _ = warm_time(run, a, reps=2)
        _emit(out, _rec("qr_tiled", name, (n, n), first, best,
                        tflops=qr_flops(n, n) / best / 1e12))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=",".join(GROUPS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        raise SystemExit(f"tileqr.bench.ops needs a GPU; JAX found {jax.default_backend()!r}")
    smi = nvidia_smi()
    out = None
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        out = open(args.out, "a")
    try:
        _emit(out, {"device": device_record(), "nvidia_smi": smi,
                    "jax": jax.__version__,
                    "cache_env": os.environ.get("JAX_COMPILATION_CACHE_DIR")})
        for g in args.only.split(","):
            if g not in GROUPS:
                raise SystemExit(f"unknown group {g!r} ({', '.join(GROUPS)})")
            t0 = time.perf_counter()
            globals()[f"group_{g}"](out)
            print(f"# group {g} took {time.perf_counter() - t0:.1f} s",
                  file=sys.stderr, flush=True)
    finally:
        if out:
            out.close()


if __name__ == "__main__":
    main()
