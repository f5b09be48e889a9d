"""Verification utilities (reference component C10, SURVEY.md §2.1).

The reference checks reconstruction residual ‖A−QR‖F/‖A‖F and per-tile
GPU-vs-CPU agreement; orthogonality ‖QᵀQ−I‖F is the standard companion.
These helpers compute the acceptance metrics without a device matmul: in
float64 on the host (``qr_check``, ``residual_via_qt``), or as sums of
squares of differences on the device (the streamed forms) — verifying with
a device matmul at default precision (TF32 on the GPU) would misreport the
residual by ~1e-3.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np


def qr_check(a, q, r) -> Dict[str, float]:
    """Acceptance metrics for a computed QR: reconstruction relerr,
    orthogonality defect, and R-triangularity defect (all float64)."""
    a = np.asarray(a, np.float64)
    q = np.asarray(q, np.float64)
    r = np.asarray(r, np.float64)
    na = np.linalg.norm(a)
    k = q.shape[1]
    return {
        "relerr": float(np.linalg.norm(a - q @ r) / (na if na else 1.0)),
        "orth": float(np.linalg.norm(q.T @ q - np.eye(k))),
        "r_lower": float(np.linalg.norm(np.tril(r[: r.shape[1]], -1))),
    }


def residual_via_qt(a, qta, r) -> float:
    """‖QᵀA − R‖F/‖A‖F — the cheap residual (no Q formation): by
    orthogonality it equals ‖A − QR‖F/‖A‖F."""
    a = np.asarray(a, np.float64)
    qta = np.asarray(qta, np.float64)
    r = np.asarray(r, np.float64)
    return float(np.linalg.norm(qta - r) / np.linalg.norm(a))


def relerr_streamed(
    apply_qt: Callable, a, r, col_block: int = 2048, n_cols: int = None
) -> float:
    """FULL-WIDTH ‖QᵀA − R‖F/‖A‖F without materializing QᵀA — the
    memory-safe contract-scale residual (VERDICT r3 missing-#1: at 32768²
    fp32, QᵀA is another 4 GiB; a column-slice check understates the error
    of paths whose error grows with the column count, so slices are not
    acceptance rows).

    apply_qt: C (M, p) → QᵀC (M, p) on device (e.g.
    ``lambda c: api.apply_q(f, c, trans=True)``). a: (M, N) device array, OR
    a callable ``(j0, j1) -> (M, j1-j0) device block`` regenerating A's
    column blocks (with ``n_cols`` giving N) — for paths whose factors
    already fill device memory and cannot hold A alongside (A is rebuilt
    block-wise from per-block PRNG keys). r: (K, N) device array, K <= M; rows K..M of QᵀA
    are compared against zero (the ‖A − QR‖F ≡ ‖QᵀA − [R; 0]‖F identity
    needs them).

    Per column block: one narrow apply + a jitted fp32 block sum-of-squares
    (an XLA tree reduce; entries are O(‖A‖·relerr) so fp32 partials carry
    ~1e-3 relative error on the final norm — far below acceptance
    resolution). Host accumulates the block partials in float64."""
    import jax
    import jax.numpy as jnp

    if callable(a):
        if n_cols is None:
            raise ValueError("callable a requires n_cols")
        get_blk, n = a, n_cols
    else:
        a = jnp.asarray(a)
        n = a.shape[1]

        def get_blk(j0, j1):
            return a[:, j0:j1]

    r = jnp.asarray(r)
    k = r.shape[0]

    @jax.jit
    def _blk_sumsq(qta_blk, r_blk):
        d_top = qta_blk[:k] - r_blk
        ss = jnp.sum(jnp.square(d_top))
        if qta_blk.shape[0] > k:
            ss = ss + jnp.sum(jnp.square(qta_blk[k:]))
        return ss

    @jax.jit
    def _a_sumsq(a_blk):
        return jnp.sum(jnp.square(a_blk))

    num = 0.0
    den = 0.0
    for j0 in range(0, n, col_block):
        j1 = min(j0 + col_block, n)
        a_blk = get_blk(j0, j1)
        # denominator BEFORE the apply: chunked apply paths DONATE their
        # input buffer, deleting a_blk
        den += float(jax.device_get(_a_sumsq(a_blk)))
        qta = apply_qt(a_blk)
        num += float(jax.device_get(_blk_sumsq(qta, r[:, j0:j1])))
    return float(np.sqrt(num) / np.sqrt(den if den else 1.0))


def orth_streamed(
    apply_q: Callable,
    apply_qt: Callable,
    m: int,
    probes: int = 1024,
    block: int = 512,
    seed: int = 0,
    dtype=None,
) -> float:
    """Streamed estimate of the orthogonality defect ‖QᵀQ − I‖F without
    forming Q (VERDICT r4 missing-#3: at contract scale Q is another 4 GiB
    and QᵀQ a dense 32768² product; the acceptance rows carried backward
    error only, and the hr family's Q comes from CholeskyQR2 +
    reconstruction — its orthogonality was asserted by algebra, never
    measured at size).

    Gaussian probe blocks E (M, p) satisfy E‖(QᵀQ−I)E‖F² = p·‖QᵀQ−I‖F², so
    sqrt(Σ‖Qᵀ(Q·E) − E‖F² / probes) is an unbiased-in-square estimator of
    the Frobenius defect, computed entirely through the factor-apply path
    (one apply_q + one apply_qt per block; blocks regenerated from PRNG
    keys because the chunked applies DONATE their input). The estimate
    includes the applies' own fp32 rounding (~√m·eps per entry), so it is
    an upper bound on the factor's true defect with a measurement floor of
    that order — exactly the quantity a user of apply_q/orgqr experiences.

    apply_q / apply_qt: C (M, p) → QC / QᵀC on device. Returns the
    estimated ‖QᵀQ − I‖F (float)."""
    import jax
    import jax.numpy as jnp

    dtype = dtype or jnp.float32

    @jax.jit
    def _probe(key):
        return jax.random.normal(key, (m, block), dtype)

    @jax.jit
    def _defect_sumsq(out, key):
        return jnp.sum(jnp.square(out - _probe(key)))

    num = 0.0
    nblk = -(-probes // block)
    for j in range(nblk):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), j)
        e = _probe(key)
        out = apply_qt(apply_q(e))
        num += float(jax.device_get(_defect_sumsq(out, key)))
    return float(np.sqrt(num / (nblk * block)))


def tiles_bitwise_equal(x, y) -> bool:
    """The reference's 'bitwise-stable tile outputs' gate: exact equality
    across reruns on the same backend (also the race detector)."""
    import jax

    xs = jax.tree_util.tree_leaves(x)
    ys = jax.tree_util.tree_leaves(y)
    return len(xs) == len(ys) and all(
        (np.asarray(xa) == np.asarray(ya)).all() for xa, ya in zip(xs, ys)
    )


def sign_canonical_r(r):
    """Flip row signs so diag(R) >= 0 — canonical form for comparing Rs from
    different elimination orders (QR is unique only up to column signs)."""
    r = np.asarray(r)
    k = min(r.shape)
    s = np.sign(np.diag(r)[:k])
    s[s == 0] = 1
    out = r.copy()
    out[:k] = r[:k] * s[:, None]
    return out
