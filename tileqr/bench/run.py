"""Benchmark sweep harness (reference component C11, SURVEY.md §2.1/§5).

Emits one JSON line per measurement (size, nb, precision, wall ms,
TFLOP/s, relerr) naming the device it ran on; the first line names the
card and its power limit.

Timing: each measured function is run once to compile (reported as
``compile_s``), then timed warm with ``block_until_ready``; the record
keeps the best of ``chain`` warm runs.

Usage (the command line requires a GPU):
  python -m tileqr.bench.run --sizes 4096,16384 --nbs 256 --precisions highest
  python -m tileqr.bench.run --mode tsqr --sizes 1048576 --cols 512
  python -m tileqr.bench.run --mode batched --batch 4096 --cols 128
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess

import numpy as np

import jax
import jax.numpy as jnp

from tileqr.utils.profiling import warm_time


def qr_flops(m, n):
    return 2.0 * n * n * (m - n / 3.0)


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def device_record():
    """Where a record was measured: JAX's view of the first device."""
    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "count": len(jax.devices())}


def bench_square(n, nb, precision, chain, check, chunk=0, method="hh"):
    """One square-QR measurement of a shipping path:

      --method hh    tiled Householder (drivers/square.py; the loop
                     driver past square.STATIC_MAX_PANELS panels at chunk 0)
      --method hr    CholeskyQR2 + Householder reconstruction
                     (drivers/square_hr.py; the segmented driver past
                     square.STATIC_MAX_PANELS panels)

    --check emits the FULL-WIDTH streamed relerr
    (utils.verify.relerr_streamed)."""
    from tileqr.drivers import square, square_hr

    if method == "hr" and n % nb:
        raise SystemExit(f"hr bench requires n % nb == 0 (got {n}, {nb})")
    a = jax.random.normal(jax.random.PRNGKey(0), (n, n), jnp.float32)
    segmented = n // nb > square.STATIC_MAX_PANELS and (method == "hr" or chunk == 0)

    if method == "hr":
        if segmented:
            def run(x):
                # the segmented driver donates its input: factor a copy
                return square_hr.qr_hr_chunked(x + 0, nb, precision=precision)
        else:
            run = jax.jit(
                lambda x: square_hr.qr_hr(x, nb, precision=precision)
            )
    elif segmented:
        run = functools.partial(square.qr_tiled_loop, nb=nb, precision=precision)
    else:
        run = jax.jit(
            lambda x: square.qr_tiled(x, nb, chunk=chunk, precision=precision)
        )
    first, t, out = warm_time(run, a, reps=chain)

    rec = {
        "bench": "qr_square", "method": method, "n": n, "nb": nb,
        "chunk": chunk, "precision": precision, "segmented": segmented,
        "compile_s": round(first - t, 6), "ms": round(t * 1e3, 6),
        "tflops": round(qr_flops(n, n) / t / 1e12, 9),
        "device": device_record(),
    }
    if check:
        from tileqr.utils.verify import relerr_streamed

        if method == "hr":
            r, panels = out
            apply = (square_hr.apply_q_hr_chunked if segmented
                     else square_hr.apply_q_hr)

            def apply_qt(c):
                return apply(panels, c + 0, nb, trans=True, precision="highest")
        else:
            packed, r_diag, t_geqrt, panels = out
            r = square.assemble_r(packed, r_diag, nb)

            apply = square.apply_q_loop if segmented else square.apply_q_tiled

            def apply_qt(c):
                return apply(panels, t_geqrt, c, nb, trans=True, precision="highest")
        rec["relerr"] = relerr_streamed(apply_qt, a, r, col_block=min(n, 2048))
    return rec


def bench_jnp_qr(n, chain):
    """``jnp.linalg.qr(mode="r")`` (geqrf: cuSOLVER on the GPU) on the same
    kind of matrix — the library baseline every square row is read against."""
    a = jax.random.normal(jax.random.PRNGKey(0), (n, n), jnp.float32)
    first, t, _ = warm_time(jax.jit(lambda x: jnp.linalg.qr(x, mode="r")), a,
                            reps=chain)
    return {
        "bench": "jnp_linalg_qr", "n": n, "compile_s": round(first - t, 6),
        "ms": round(t * 1e3, 6),
        "tflops": round(qr_flops(n, n) / t / 1e12, 9),
        "device": device_record(),
    }


def bench_tsqr(m, cols, nb, chain, strategy="tree", check=False,
               precision="highest"):
    """Tall-skinny measurement through the PUBLIC tsqr API so every shipping
    strategy is one CLI line (VERDICT r3 weak-#2):

      --strategy tree      TSQR/TTQRT tree (the factor/apply + cross-chip path)
      --strategy chain     chunked square driver, one wide panel (the
                           single-chip auto default)
      --strategy cholqr2   gram + batched POTRF + matmul correction (fastest
                           single-chip R, cond(A) ≲ 1e3 contract)

    --check compares R against numpy's (sign-fixed row signs — R-uniqueness,
    SURVEY §4 tall-skinny row)."""
    import tileqr

    # hr_guard="off" keeps the cholqr2 path traceable under jit (the guard's
    # fallback branch is a host decision)
    cfg = tileqr.QRConfig(nb=max(nb, cols), precision=precision, hr_guard="off")
    a = jax.random.normal(jax.random.PRNGKey(0), (m, cols), jnp.float32)
    run = jax.jit(lambda x: tileqr.tsqr(x, mode="r", config=cfg, strategy=strategy))
    first, t, _ = warm_time(run, a, reps=chain)
    rec = {
        # nb_cfg: QRConfig(nb=max(nb, cols)) only bounds the panel width;
        # the tree's leaf height is auto_leaf_rows
        "bench": "tsqr", "strategy": strategy, "m": m, "n": cols,
        "nb_cfg": max(nb, cols),
        "precision": precision, "compile_s": round(first - t, 6),
        "ms": round(t * 1e3, 6),
        "tflops": round(qr_flops(m, cols) / t / 1e12, 9),
        "device": device_record(),
    }
    if check:
        r = np.asarray(
            tileqr.tsqr(a, mode="r", config=cfg, strategy=strategy),
            np.float64,
        )
        r_np = np.linalg.qr(np.asarray(a, np.float64), mode="r")
        # sign-fix both to positive diagonals (R unique up to row signs)
        r = np.where(np.diag(r) < 0, -1.0, 1.0)[:, None] * r
        r_np = np.where(np.diag(r_np) < 0, -1.0, 1.0)[:, None] * r_np
        rec["relerr_r"] = float(
            np.linalg.norm(r - r_np) / np.linalg.norm(r_np)
        )
    return rec


def bench_batched(batch, cols, chain, check=False, method="hh"):
    """Measures the production qr_batched path: method="hh" (batched
    Householder, drivers/batched.py) or "cholqr2" (drivers/cholqr.py)."""
    from tileqr.drivers.batched import qr_batched as _hh
    from tileqr.drivers.cholqr import cholqr2_batched

    a = jax.random.normal(jax.random.PRNGKey(0), (batch, cols, cols), jnp.float32)
    qr_batched = cholqr2_batched if method == "cholqr2" else _hh
    first, t, (q, r) = warm_time(jax.jit(qr_batched), a, reps=chain)
    rec = {
        "bench": "qr_batched",
        "kernel": method,
        "batch": batch, "n": cols,
        "compile_s": round(first - t, 6),
        "ms": round(t * 1e3, 6),
        "tflops": round(batch * qr_flops(cols, cols) / t / 1e12, 9),
        "device": device_record(),
    }
    if check:
        q64 = np.asarray(q).astype(np.float64)
        r64 = np.asarray(r).astype(np.float64)
        a64 = np.asarray(a).astype(np.float64)
        num = np.linalg.norm(q64 @ r64 - a64, axis=(1, 2))
        den = np.linalg.norm(a64, axis=(1, 2))
        rec["relerr_max"] = float((num / den).max())
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="square", choices=["square", "tsqr", "batched", "baseline"])
    ap.add_argument("--sizes", default="4096")
    ap.add_argument("--nbs", default="256")
    ap.add_argument("--precisions", default="highest",
                    help="comma list of highest,high,default")
    ap.add_argument("--method", default="hh", choices=["hh", "hr"],
                    help="square path: tiled Householder or CholeskyQR2+"
                    "Householder-reconstruction")
    ap.add_argument("--strategy", default="tree",
                    choices=["tree", "chain", "cholqr2"],
                    help="tsqr mode only")
    ap.add_argument("--cols", type=int, default=512)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--chain", type=int, default=3,
                    help="warm runs per measurement (the best is kept)")
    ap.add_argument("--chunk", type=int, default=0)
    ap.add_argument("--check", action="store_true", help="also compute relerr")
    ap.add_argument("--batched-method", default="hh", choices=["hh", "cholqr2"])
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        raise SystemExit(f"tileqr.bench.run needs a GPU; JAX found {jax.default_backend()!r}")
    print(json.dumps({"device": device_record(), "card": nvidia_smi()}), flush=True)

    for n in [int(s) for s in args.sizes.split(",")]:
        if args.mode == "square":
            for nb in [int(x) for x in args.nbs.split(",")]:
                for prec in args.precisions.split(","):
                    print(json.dumps(bench_square(
                        n, nb, prec, args.chain, args.check, args.chunk,
                        args.method)), flush=True)
        elif args.mode == "baseline":
            print(json.dumps(bench_jnp_qr(n, args.chain)), flush=True)
        elif args.mode == "tsqr":
            for nb in [int(x) for x in args.nbs.split(",")]:
                for prec in args.precisions.split(","):
                    print(json.dumps(bench_tsqr(
                        n, args.cols, nb, args.chain, args.strategy,
                        args.check, prec)), flush=True)
        elif args.mode == "batched":
            print(json.dumps(bench_batched(
                args.batch, args.cols, args.chain, args.check,
                args.batched_method)), flush=True)


if __name__ == "__main__":
    main()
