"""Batched CholeskyQR2: QR of a (B, m, n) stack with matmuls and one
Cholesky per matrix.

Pipeline:

  1. G = AᵀA              — batched gram (HIGHEST, pairwise accumulation).
  2. R1 = potrf(G)        — the one serial step (cuSOLVER ``potrf``).
  3. S1 ≈ R1⁻¹            — log-doubling triangular inverse: R = D(I+N)
     with N strictly upper ⇒ (I+N)⁻¹ = Π (I + (−N)^(2^i)), 2·log2(n)
     batched matmuls, NO serial substitution.
  4. Q1 = A·S1            — HIGHEST matmul.
  5. Orthogonality correction (replaces CholeskyQR2's SECOND Cholesky with
     matmuls): G2 = Q1ᵀQ1 = I + E with ‖E‖ small; the Cholesky factor of
     I + E is I + U with U = up(E − UᵀU) (up = strict upper + half diag),
     iterated to quadratic convergence — masked HIGHEST matmuls only. Then
     Q = Q1·(I+U)⁻¹ via the truncated Neumann series (‖U‖ ≪ 1).
  6. R = triu(Qᵀ A)       — one HIGHEST matmul. This decouples the final
     residual from every inverse above: ‖A − QR‖ = ‖(I − QQᵀ)A − Q·low(QᵀA)‖
     is governed by Q's orthogonality alone, which step 5 pins at fp32.

Caveat (documented CholeskyQR territory): step 2 requires cond(A)² · eps to
be comfortably < 1 (cond(A) ≲ 1e3 in fp32). Ill-conditioned inputs should
use the Householder paths, which are unconditionally stable.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from tileqr.kernels.common import acc_type, bdot_pair_rows, resolve_precision


def _bdot(x, y, contract, precision, dt):
    out = jax.lax.dot_general(
        x, y, dimension_numbers=(contract, ((0,), (0,))),
        precision=precision, preferred_element_type=acc_type(dt),
    )
    return out.astype(dt)


def guard_trips(health, cfg, where: str) -> bool:
    """Host check of a CholeskyQR breakdown scalar (round-1 orthogonality
    defect from the ``stats`` outputs). True ⇒ the defect exceeds
    cfg.hr_guard_tau (or is NaN) and a warning was emitted; the caller
    decides fallback vs keep per cfg.hr_guard. Inside a jax.jit trace
    (tracer health) the check is impossible and returns False — the caller
    keeps the CholeskyQR result and the scalar flows out for the user to
    gate on."""
    if health is None or isinstance(health, jax.core.Tracer):
        return False
    h = float(jax.device_get(health))
    if h <= cfg.hr_guard_tau:  # NaN fails the comparison → guard trips
        return False
    import warnings

    action = (
        "falling back to the unconditionally stable Householder path"
        if cfg.hr_guard == "fallback"
        else "keeping the CholeskyQR result (hr_guard='warn')"
    )
    warnings.warn(
        f"tileqr hr guard [{where}]: CholeskyQR round-1 orthogonality "
        f"defect {h:.3e} exceeds hr_guard_tau={cfg.hr_guard_tau:.1e} — the "
        f"conditioning contract (cond ≲ 1e3 in fp32) is broken; {action}."
    )
    return True


def _inv_factors(r, precision):
    """R = D(I+N) with N strictly upper nilpotent: yields (dinv, [X, X²,
    X⁴, …]) such that R⁻¹ = (I+X)(I+X²)(I+X⁴)… D⁻¹ with X = −N (the
    geometric-series factorization Σ X^k = Π (I + X^(2^i)))."""
    b, n, _ = r.shape
    dt = r.dtype
    dinv = 1.0 / jnp.diagonal(r, axis1=1, axis2=2)
    eye = jnp.eye(n, dtype=dt)
    x = eye - r * dinv[:, :, None]  # = −N, strictly upper
    pows = [x]
    for _ in range(1, max(1, (n - 1).bit_length())):
        pows.append(_bdot(pows[-1], pows[-1], ((2,), (1,)), precision, dt))
    return dinv, pows


def _apply_rinv(c, dinv, pows, precision):
    """C ← C R⁻¹ without materializing R⁻¹: fold the doubling factors in as
    (((C(I+X))(I+X²))…)·D⁻¹ — log2(n) (B, m, n)@(B, n, n) matmuls."""
    dt = c.dtype
    for p in pows:
        c = c + _bdot(c, p, ((2,), (1,)), precision, dt)
    return c * dinv[:, None, :]


def _triu_inv_doubling(r, precision):
    """Batched upper-triangular inverse, matmul-only (see _inv_factors)."""
    dinv, pows = _inv_factors(r, precision)
    eye = jnp.eye(r.shape[-1], dtype=r.dtype)
    return _apply_rinv(jnp.broadcast_to(eye, r.shape), dinv, pows, precision)


def _up_half(e):
    """up(E): strict upper + half diagonal (the triangular 'half' of a
    symmetric perturbation)."""
    n = e.shape[-1]
    rows = jax.lax.broadcasted_iota(jnp.int32, (1, n, n), 1)
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, n, n), 2)
    return jnp.where(
        rows < cols, e, jnp.where(rows == cols, e * 0.5, jnp.zeros_like(e))
    )


def potrf(g_mat):
    """Batched upper Cholesky of (B, n, n) grams through
    ``lax.linalg.cholesky`` (cuSOLVER potrf/potrfBatched on the GPU, LAPACK
    on the CPU). A breakdown yields NaN, which the CholeskyQR breakdown
    guard reads as tripped."""
    low = jax.lax.linalg.cholesky(
        g_mat.astype(acc_type(g_mat.dtype)), symmetrize_input=False
    )
    return jnp.swapaxes(low, -1, -2).astype(g_mat.dtype)


@functools.partial(
    jax.jit,
    static_argnames=("mode", "precision", "correction_iters", "stats"),
)
def cholqr2_batched(
    a,
    mode: str = "reduced",
    precision: str = "highest",
    correction_iters: int = 2,
    stats: bool = False,
):
    """Batched CholeskyQR2: a (B, m, n), m >= n → (Q (B, m, n), R (B, n, n))
    or R only (mode="r"). See module docstring for the pipeline and the
    conditioning caveat.

    stats=True appends ``emax`` = max over the batch of ‖Q₁ᵀQ₁ − I‖_max —
    the round-1 orthogonality defect, ≈ cond(A)²·eps. This is the natural
    breakdown detector for the CholeskyQR family: the correction round
    restores orthogonality to fp32 only while ‖E‖ ≪ 1 (the truncated
    chol(I+E) iteration + cubic Neumann inverse leave O(‖E‖⁴)), and a POTRF
    breakdown (clamped/NaN pivot) sends ‖E‖ → huge/NaN. The reduce reuses
    the already-computed E — no extra passes over A. Scalar is emitted with
    NaN-propagating max so a NaN anywhere trips a `<= tau` gate."""
    b, m, n = a.shape
    dt = a.dtype
    hi = resolve_precision(precision)
    eye = jnp.eye(n, dtype=dt)

    # Tall contractions (gram, Q1 gram, final R) accumulate PAIRWISE: the
    # sequential fp32 accumulation over m rows is where the CholeskyQR
    # paths' √m backward-error growth lives. Short matrices (m < 1024) fall
    # back to the plain contraction inside bdot_pair_rows.
    g = bdot_pair_rows(a, a, hi)  # (B, n, n) gram
    r1 = potrf(g)
    # Q1 = A R1⁻¹ at FULL precision: a reduced-precision pass here leaves an
    # out-of-span component in Q1 that the orthogonality correction cannot
    # remove (it rotates within span(Q1)). Shape-dependent application:
    # folding the doubling factors into A saves the inverse-build matmuls
    # when m ≈ n; TALL a builds S1 = R1⁻¹ explicitly (small n×n matmuls)
    # and touches the big matrix exactly once.
    if m > 2 * n:
        s1 = _triu_inv_doubling(r1, hi)
        q1 = _bdot(a, s1, ((2,), (1,)), hi, dt)
    else:
        dinv, pows = _inv_factors(r1, hi)
        q1 = _apply_rinv(a, dinv, pows, hi)

    # matmul-only second round: chol(I+E) = I + U, U = up(E - UᵀU) iterated
    e = bdot_pair_rows(q1, q1, hi) - eye
    if stats:
        # a NaN in E must yield emax=NaN, whatever the max reduction does
        emax = jnp.where(
            jnp.any(jnp.isnan(e)), jnp.asarray(jnp.nan, dt), jnp.max(jnp.abs(e))
        )
    u = _up_half(e)
    for _ in range(correction_iters):
        utu = _bdot(jnp.swapaxes(u, 1, 2), u, ((2,), (1,)), hi, dt)
        u = _up_half(e - utu)
    # Q = Q1 (I+U)^{-1} ≈ Q1 (I - U + U² - U³) — Horner, ‖U‖ ≪ 1
    w = eye - u
    w = eye - _bdot(u, w, ((2,), (1,)), hi, dt)
    w = eye - _bdot(u, w, ((2,), (1,)), hi, dt)
    q = _bdot(q1, w, ((2,), (1,)), hi, dt)

    # final R from the corrected Q: residual rides Q's orthogonality only
    r = bdot_pair_rows(q, a, hi)
    rows = jax.lax.broadcasted_iota(jnp.int32, (1, n, n), 1)
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, n, n), 2)
    r = jnp.where(rows <= cols, r, jnp.zeros_like(r))
    if mode == "r":
        return (r, emax) if stats else r
    return (q, r, emax) if stats else (q, r)
