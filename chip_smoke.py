#!/usr/bin/env python
"""Smoke run of tileqr compiled on one GPU: the quickest proof that the
library still starts, compiles and factors correctly on the card.

  python chip_smoke.py [--seed N]         # one card, every phase below
  python chip_smoke.py --four-cards       # qr_sharded on four cards only

Phases (one process; inputs generated on the device from --seed; every
check raises, so any failure exits non-zero):

  0. device: the default backend must be the GPU — there is no CPU path.
  1. each tile op at real widths against the numpy reference
     (tileqr/ref/tile_ops.py, float64 on the host).
  2. square QR through the public API: the default (hh) config at 4096²,
     16384² and 32768², square_method="hr" at 16384² and 32768²; the
     full-width residual, the orthogonality against jnp.linalg.qr's, and
     lstsq at 4096² against scipy's float64 solve.
  3. tsqr at 1048576×512 (modes r and factor, apply_q on its factors) and
     qr_batched at 4096×128².

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

# The repo's acceptance gate on ‖QᵀA − [R; 0]‖F / ‖A‖F for every
# factorization (float32 at full width).
RELERR_GATE = 1e-6
# tileqr's Q may be at most this many times less orthogonal than the one
# jnp.linalg.qr (cuSOLVER geqrf + orgqr) gives on the same matrix.
ORTH_FACTOR = 10.0

SQUARE_RUNS = (("hh", 4096), ("hh", 16384), ("hh", 32768), ("hr", 16384), ("hr", 32768))
TSQR_SHAPE = (1048576, 512)
BATCH_SHAPE = (4096, 128, 128)
NB = 256


def log(msg: str) -> None:
    print(msg, flush=True)


def check(name: str, value: float, tol: float, why: str, smaller: bool = True) -> None:
    ok = value <= tol if smaller else value >= tol
    log(f"  {'PASS' if ok else 'FAIL'} {name}: {value:.3e} "
        f"({'<=' if smaller else '>='} {tol:.1e}; {why})")
    if not ok:
        raise AssertionError(f"{name} = {value:.3e} fails {tol:.1e}")


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (den if den else 1.0))


def card() -> str:
    from tileqr.bench.run import nvidia_smi

    return nvidia_smi()


def peak_bytes(dev) -> int:
    return int(dev.memory_stats()["peak_bytes_in_use"])


def _geqrt_lapack(a):
    """The GEQRT contract of ref/tile_ops.geqrt for a tall float64 block,
    through LAPACK dgeqrf (numpy) and the xLARFT recurrence
    T[:j, j] = −τ_j T[:j, :j] (VᵀV)[:j, j]: the pure-numpy column loop of
    the reference is too slow at leaf heights."""
    h, taus = np.linalg.qr(a, mode="raw")
    packed = h.T
    n = a.shape[1]
    v = np.tril(packed, -1)[:, :n] + np.eye(a.shape[0], n)
    g = v.T @ v
    t = np.zeros((n, n))
    for j in range(n):
        t[:j, j] = -taus[j] * (t[:j, :j] @ g[:j, j])
        t[j, j] = taus[j]
    return packed, t


def phase_ops(key, nb: int = NB, batch=BATCH_SHAPE, tsqr_shape=TSQR_SHAPE):
    """Every translated op at real widths against the float64 reference."""
    import jax
    import jax.numpy as jnp

    from tileqr.drivers import batched, cholqr, tsqr
    from tileqr.kernels import modlu
    from tileqr.kernels import tile_ops as T
    from tileqr.ref import tile_ops as ref

    log("phase 1: tile ops vs the float64 reference")
    why = "float32 rounding, another reduction order than the reference"
    ks = jax.random.split(key, 8)
    host = lambda x: np.asarray(x, np.float64)  # noqa: E731

    a = jax.random.normal(ks[0], (nb, nb), jnp.float32)
    pk, t = jax.jit(T.geqrt)(a)
    pk_r, t_r = ref.geqrt(host(a))
    check(f"geqrt {nb}x{nb} packed", rel(pk, pk_r), 1e-5, why)
    check(f"geqrt {nb}x{nb} T", rel(t, t_r), 1e-5, why)

    r = jnp.triu(jax.random.normal(ks[1], (nb, nb), jnp.float32))
    b = jax.random.normal(ks[2], (4 * nb, nb), jnp.float32)
    r1, v2, t2 = jax.jit(T.tsqrt)(r, b)
    rr, vr, tr = ref.tsqrt(host(r), host(b))
    check(f"tsqrt [{nb}; {4 * nb}] R", rel(r1, rr), 1e-5, why)
    check(f"tsqrt [{nb}; {4 * nb}] V2", rel(v2, vr), 1e-5, why)
    check(f"tsqrt [{nb}; {4 * nb}] T2", rel(t2, tr), 1e-5, why)

    r2 = jnp.triu(b[:nb])
    ro, v2t, _ = jax.jit(T.ttqrt)(r, r2)
    rr, vr, _ = ref.ttqrt(host(r), host(r2))
    check(f"ttqrt {nb} R", rel(ro, rr), 1e-5, why)
    check(f"ttqrt {nb} V2", rel(v2t, vr), 1e-5, why)

    c = jax.random.normal(ks[3], (nb, 16 * nb), jnp.float32)
    cb = jax.random.normal(ks[4], (4 * nb, 16 * nb), jnp.float32)
    _, vr32, tr32 = ref.tsqrt(host(r), host(b))
    for trans in (True, False):
        got = jax.jit(T.larfb, static_argnums=3)(
            jnp.asarray(pk_r, jnp.float32), jnp.asarray(t_r, jnp.float32), c, trans)
        check(f"larfb trans={trans}", rel(got, ref.larfb(pk_r, t_r, host(c), trans)), 1e-5, why)
        gt, gb = jax.jit(T.ssrfb, static_argnums=4)(
            jnp.asarray(vr32, jnp.float32), jnp.asarray(tr32, jnp.float32), c, cb, trans)
        wt, wb = ref.ssrfb(vr32, tr32, host(c), host(cb), trans)
        check(f"ssrfb trans={trans}", max(rel(gt, wt), rel(gb, wb)), 1e-5, why)

    q = jnp.linalg.qr(jax.random.normal(ks[5], (2 * nb, nb), jnp.float32))[0][:nb]
    lu, d = modlu.modified_lu(q)
    lu = host(lu)
    lower = np.tril(lu, -1) + np.eye(nb)
    upper = np.triu(lu)
    err = np.abs(lower @ upper - (host(q) - np.diag(host(d)))).max()
    check(f"modified LU {nb}: max|L·U − (Q1 − diag d)|", err, 1e-5,
          "entries ≤ 2, float32 rounding over nb steps")
    check(f"modified LU {nb}: min|u_jj|", np.abs(np.diag(upper)).min(), 1.0 - 1e-6,
          "the sign choice bounds every pivot to [1, 2]", smaller=False)

    for bsz, n in ((1, nb), (batch[0], batch[2])):
        x = jax.random.normal(ks[6], (bsz, 2 * n, n), jnp.float32)
        g = jnp.einsum("bmi,bmj->bij", x, x, precision="highest")
        rg = host(jax.jit(cholqr.potrf)(g))
        g64 = host(g)
        err = np.abs(np.swapaxes(rg, 1, 2) @ rg - g64).max() / np.abs(g64).max()
        check(f"potrf ({bsz}, {n}): max|RᵀR − G|/max|G|", err, 1e-5, why)

    ab = jax.random.normal(ks[7], batch, jnp.float32)
    qb, rb = batched.qr_batched(ab)
    res = jnp.einsum("bij,bjk->bik", qb, rb, precision="highest") - ab
    relb = float(jnp.max(jnp.linalg.norm(res, axis=(1, 2)) / jnp.linalg.norm(ab, axis=(1, 2))))
    check(f"qr_batched {batch}: max ‖QR − A‖F/‖A‖F", relb, RELERR_GATE, "the repo's gate")

    m, n = tsqr_shape
    lr = tsqr.auto_leaf_rows(m, n)
    leaves = jax.random.normal(key, (m, n), jnp.float32)
    pk_l, t_l = jax.jit(tsqr.leaf_geqrt, static_argnums=1)(leaves, lr)
    pk_0, t_0 = _geqrt_lapack(host(leaves[:lr]))
    why_l = why.replace("the reference", "LAPACK float64")
    check(f"tsqr leaf set {m}x{n} (leaf {lr}) leaf-0 packed", rel(pk_l[:lr], pk_0), 1e-5, why_l)
    check(f"tsqr leaf set {m}x{n} (leaf {lr}) leaf-0 T", rel(t_l[0], t_0), 1e-5, why_l)


def _r_of(f):
    from tileqr.api import HRFactors
    from tileqr.drivers.square import assemble_r

    m, n = f.shape
    k = min(m, n)
    if isinstance(f, HRFactors):
        return (f.r * f.scale)[:k, :n]
    return (assemble_r(f.packed, f.r_diag, f.nb) * f.scale)[:k, :n]


def _orth_jnp(a, n):
    """‖QᵀQ − I‖F estimate for jnp.linalg.qr's Q, by the same probes."""
    import jax
    import jax.numpy as jnp

    from tileqr import orth_streamed

    q = jax.jit(lambda x: jnp.linalg.qr(x)[0])(a)
    mm = jax.jit(lambda x, e: jnp.matmul(x, e, precision="highest"))
    mt = jax.jit(lambda x, e: jnp.matmul(x.T, e, precision="highest"))
    return orth_streamed(lambda e: mm(q, e), lambda e: mt(q, e), n, probes=512, block=512)


def phase_square(key, runs=SQUARE_RUNS, lstsq_n: int = 4096, nb: int = NB):
    import jax
    import jax.numpy as jnp
    import scipy.linalg

    import tileqr
    from tileqr.bench.run import qr_flops
    from tileqr.utils.profiling import warm_time

    log("phase 2: square QR through the public API")
    dev = jax.devices()[0]
    name = card()
    for method, n in runs:
        cfg = tileqr.QRConfig(nb=nb, square_method=method)
        a = jax.random.normal(jax.random.fold_in(key, n), (n, n), jnp.float32)
        first, warm, f = warm_time(lambda x: tileqr.qr_factor(x, cfg), a, reps=1)
        r = _r_of(f)
        relerr = tileqr.relerr_streamed(
            lambda c: tileqr.apply_q(f, c, trans=True), a, r, col_block=512)
        orth = tileqr.orth_streamed(
            lambda e: tileqr.apply_q(f, e), lambda e: tileqr.apply_q(f, e, trans=True),
            n, probes=512, block=512)
        del f, r
        _, base, _ = warm_time(jax.jit(lambda x: jnp.linalg.qr(x, mode="r")), a, reps=1)
        orth_ref = _orth_jnp(a, n)
        log(f"  {method} {n}x{n} nb={nb} [{name}]: compile {first - warm:.2f} s (set-up), "
            f"warm {warm * 1e3:.2f} ms, {qr_flops(n, n) / warm / 1e12:.3f} TFLOP/s; "
            f"jnp.linalg.qr(mode='r') {base * 1e3:.2f} ms; "
            f"peak_bytes_in_use {peak_bytes(dev)}")
        check(f"{method} {n}² ‖QᵀA − [R;0]‖F/‖A‖F", relerr, RELERR_GATE, "the repo's gate")
        check(f"{method} {n}² orth ‖QᵀQ − I‖F (jnp.linalg.qr: {orth_ref:.3e})", orth,
              ORTH_FACTOR * orth_ref, f"within {ORTH_FACTOR:.0f}x of cuSOLVER's Q")
        if n == lstsq_n and method == "hh":
            # a well-conditioned system (cond ≈ 3), so that float32 and
            # float64 solutions may be compared entry for entry
            kb = jax.random.fold_in(key, n + 1)
            als = a / np.sqrt(n) + 4 * jnp.eye(n, dtype=jnp.float32)
            b = jax.random.normal(kb, (n, 4), jnp.float32)
            x = tileqr.lstsq(als, b, config=cfg)
            x64 = scipy.linalg.lstsq(np.asarray(als, np.float64), np.asarray(b, np.float64),
                                     lapack_driver="gelsy")[0]
            check(f"lstsq {n}² vs scipy float64: ‖x − x64‖/‖x64‖", rel(x, x64), 1e-5,
                  "cond(A) ≈ 3 bounds the float32 forward error near eps")
        del a


def phase_tall_batched(key, tsqr_shape=TSQR_SHAPE, batch=BATCH_SHAPE):
    import jax
    import jax.numpy as jnp

    import tileqr
    from tileqr.bench.run import qr_flops
    from tileqr.utils.profiling import warm_time
    from tileqr.utils.verify import sign_canonical_r

    log("phase 3: tall-skinny and batched")
    dev = jax.devices()[0]
    name = card()
    m, n = tsqr_shape
    cfg = tileqr.QRConfig(nb=max(NB, n))
    a = jax.random.normal(jax.random.fold_in(key, 3), (m, n), jnp.float32)
    first, warm, r = warm_time(lambda x: tileqr.tsqr(x, mode="r", config=cfg), a, reps=1)
    log(f"  tsqr(mode='r', strategy='auto') {m}x{n} [{name}]: compile {first - warm:.2f} s, warm "
        f"{warm * 1e3:.2f} ms, {qr_flops(m, n) / warm / 1e12:.3f} TFLOP/s; "
        f"peak_bytes_in_use {peak_bytes(dev)}")
    first, warm, f = warm_time(
        lambda x: tileqr.tsqr(x, mode="factor", config=cfg, strategy="tree"), a, reps=1)
    log(f"  tsqr(mode='factor', strategy='tree') {m}x{n}: compile {first - warm:.2f} s, "
        f"warm {warm * 1e3:.2f} ms")
    relerr = tileqr.relerr_streamed(lambda c: tileqr.apply_q(f, c, trans=True), a, f.r,
                                    col_block=n)
    check(f"tsqr factor {m}x{n} ‖QᵀA − [R;0]‖F/‖A‖F (apply_q)", relerr, RELERR_GATE,
          "the repo's gate")
    r_tree = f.r[:n, :n]
    check("tsqr mode='r' (chain) vs mode='factor' (tree) R, row signs fixed",
          rel(sign_canonical_r(np.asarray(r)), sign_canonical_r(np.asarray(r_tree))), 1e-5,
          "R is unique up to row signs; two elimination orders of a cond ≈ 1 "
          "matrix differ by float32 rounding")
    del f, a

    ab = jax.random.normal(jax.random.fold_in(key, 4), batch, jnp.float32)
    first, warm, (q, r) = warm_time(lambda x: tileqr.qr_batched(x), ab, reps=1)
    _, base, (qj, _) = warm_time(jax.jit(jnp.linalg.qr), ab, reps=1)
    log(f"  qr_batched {batch} [{name}]: compile {first - warm:.2f} s, warm "
        f"{warm * 1e3:.2f} ms; jnp.linalg.qr {base * 1e3:.2f} ms")
    bmm = jax.jit(lambda x, y: jnp.einsum("bij,bjk->bik", x, y, precision="highest"))
    res = bmm(q, r) - ab
    relb = float(jnp.max(jnp.linalg.norm(res, axis=(1, 2)) / jnp.linalg.norm(ab, axis=(1, 2))))
    check(f"qr_batched {batch} max ‖QR − A‖F/‖A‖F", relb, RELERR_GATE, "the repo's gate")
    eye = jnp.eye(batch[2], dtype=jnp.float32)
    orth = float(jnp.max(jnp.linalg.norm(bmm(jnp.swapaxes(q, 1, 2), q) - eye, axis=(1, 2))))
    orth_ref = float(jnp.max(jnp.linalg.norm(bmm(jnp.swapaxes(qj, 1, 2), qj) - eye, axis=(1, 2))))
    check(f"qr_batched max ‖QᵀQ − I‖F (jnp.linalg.qr: {orth_ref:.3e})", orth,
          ORTH_FACTOR * orth_ref, f"within {ORTH_FACTOR:.0f}x of cuSOLVER's Q")


def phase_four_cards(key, n: int = 32768, nb: int = NB, cards: int = 4):
    """qr_sharded hh and hr on every visible card against one-card qr (hh,
    on hh's matrix)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import tileqr
    from tileqr.drivers.sharded import make_mesh
    from tileqr.drivers.sharded_hr import ShardedHRFactors
    from tileqr.utils.profiling import warm_time

    devices = jax.devices()
    if len(devices) != cards:
        raise SystemExit(f"--four-cards needs {cards} devices, JAX sees {len(devices)}")
    log(f"phase 4: qr_sharded on {cards} cards")
    name = card()
    mesh = make_mesh(tileqr.QRConfig())
    log(f"  mesh {dict(mesh.shape)}")
    sharded = NamedSharding(mesh, P("rows", "cols"))
    gen = jax.jit(lambda k: jax.random.normal(k, (n, n), jnp.float32), out_shardings=sharded)
    a = gen(jax.random.fold_in(key, 5))
    # hr's contract is cond(A) ≲ 1e3 (CholeskyQR panels); a square gaussian
    # matrix has cond ~ n, and its late panels can trip hr's breakdown
    # guard, which then refactors with hh. hr runs on a shifted matrix
    # (cond ≈ 3) so that what is timed is hr.
    in_contract = jax.jit(lambda x: x / np.sqrt(n) + 4 * jnp.eye(n, dtype=x.dtype),
                          out_shardings=sharded)
    inputs = {"hh": a, "hr": in_contract(a)}
    results = {}
    for method in ("hh", "hr"):
        cfg = tileqr.QRConfig(nb=nb, square_method=method)
        x = inputs.pop(method)
        first, warm, f = warm_time(
            lambda x: tileqr.qr_sharded(x, mesh=mesh, config=cfg, mode="factor"), x, reps=1)
        if method == "hr" and not isinstance(f, ShardedHRFactors):
            raise AssertionError("qr_sharded hr fell back to hh: its breakdown guard tripped")
        r = tileqr.assemble_r_sharded(f, mesh)
        relerr = tileqr.relerr_streamed(
            lambda c: tileqr.apply_q_sharded(f, c, mesh=mesh, trans=True, config=cfg),
            x, r, col_block=n // 4)
        peaks = [peak_bytes(d) for d in devices]
        log(f"  qr_sharded {method} {n}x{n} [{name}] x{cards}: compile {first - warm:.2f} s, "
            f"warm {warm * 1e3:.2f} ms; peak_bytes_in_use per card {peaks}")
        check(f"qr_sharded {method} {n}² ‖QᵀA − [R;0]‖F/‖A‖F", relerr, RELERR_GATE,
              "the repo's gate")
        check(f"qr_sharded {method} peak-memory balance max/mean", max(peaks) / np.mean(peaks),
              1.5, "no card may hold the work of several")
        results[method] = (warm, relerr)
        del f, r, x
    # the one-card run last: it would lift card 0's peak above the others'
    a1 = jax.device_put(a, devices[0])
    del a
    cfg = tileqr.QRConfig(nb=nb)
    first, warm, f = warm_time(lambda x: tileqr.qr_factor(x, cfg), a1, reps=1)
    relerr = tileqr.relerr_streamed(
        lambda c: tileqr.apply_q(f, c, trans=True), a1, _r_of(f), col_block=512)
    log(f"  one-card qr hh {n}x{n} [{name}]: compile {first - warm:.2f} s, warm "
        f"{warm * 1e3:.2f} ms, relerr {relerr:.3e}; sharded hh {results['hh'][0] * 1e3:.2f} ms "
        f"({results['hh'][1]:.3e}), sharded hr {results['hr'][0] * 1e3:.2f} ms "
        f"({results['hr'][1]:.3e})")
    check(f"one-card qr {n}² ‖QᵀA − [R;0]‖F/‖A‖F", relerr, RELERR_GATE, "the repo's gate")
    return cards


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only qr_sharded on four cards and its one-card comparison")
    ap.add_argument("--n", type=int, default=32768,
                    help="matrix size of the --four-cards phase")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"chip_smoke needs a GPU; JAX's default backend is {jax.default_backend()!r}")
    from tileqr.utils.cache import configure_compile_cache

    cache = configure_compile_cache()
    dev = jax.devices()[0]
    log(card())
    log(f"device_kind {dev.device_kind}; jax {jax.__version__}; "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; compile cache {cache}")
    key = jax.random.PRNGKey(args.seed)
    t0 = time.perf_counter()
    if args.four_cards:
        count = phase_four_cards(key, n=args.n)
    else:
        phase_ops(key)
        log(f"  [{time.perf_counter() - t0:.1f} s]")
        phase_square(key)
        log(f"  [{time.perf_counter() - t0:.1f} s]")
        phase_tall_batched(key)
        count = 1
    log(f"  [{time.perf_counter() - t0:.1f} s total]")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
