"""Pure-numpy reference semantics for the five tile kernels (L0 oracle).

These are the normative contracts for the tile ops (kernels/tile_ops.py;
SURVEY.md §2.2, components C1–C5; LAPACK xGEQRT/xLARFB/xTSQRT/xTSMQR/xTTQRT
semantics, consistent with BASELINE.json:5). Every tile-op unit test
compares against these functions; the blocked-QR oracle driver
(ref/blocked_qr.py, reference component C9 "CPU reference") composes them
in the same order as the device drivers so tile outputs are comparable
tile-by-tile.

Conventions (LAPACK 'Forward'/'Columnwise' compact WY):
  * Householder reflector for a column x: beta = -sign(x0) * ||x||_2,
    v = x / (x0 - beta) with v0 = 1, tau = (beta - x0) / beta; H = I - tau v v^T.
    (xLARFG semantics; tau = 0 and v = e1 when x is already [x0, 0, ..., 0].)
  * After n columns Q = H_0 H_1 ... H_{n-1} = I - V T V^T with V unit lower
    trapezoidal and T upper triangular, built incrementally:
      T[j, j] = tau_j;  T[:j, j] = -tau_j * T[:j, :j] @ (V[:, :j]^T @ v_j).
  * "packed" storage: R on/above the diagonal, Householder v's strictly
    below (unit diagonal implicit) — LAPACK GEQRT output layout.

All routines are dtype-preserving (fp32 oracle for tile-comparison tests,
fp64 oracle for accuracy references) and use fixed sequential reduction
order, the property behind the reference's "bitwise-stable tile outputs"
requirement (BASELINE.json:5).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _larfg(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Householder generation for vector x -> (beta, v, tau), v[0] == 1."""
    dt = x.dtype
    alpha = x[0]
    tail = x[1:]
    xnorm = np.linalg.norm(tail.astype(np.float64)).astype(dt) if tail.size else dt.type(0)
    v = np.zeros_like(x)
    v[0] = 1
    if xnorm == 0:
        return alpha, v, dt.type(0)
    sign = dt.type(1) if alpha >= 0 else dt.type(-1)
    beta = dt.type(-sign * np.hypot(np.float64(alpha), np.float64(xnorm)))
    tau = (beta - alpha) / beta
    v[1:] = tail / (alpha - beta)
    return beta, v, dt.type(tau)


def geqrt(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """C1 GEQRT: QR-factorize an m×n tile (m >= n).

    Returns (packed, T): packed holds R above/on the diagonal and the
    Householder vectors strictly below it; T is the n×n upper-triangular
    compact-WY factor with Q = I - V T V^T.
    """
    a = np.array(a, copy=True)
    m, n = a.shape
    dt = a.dtype
    v_full = np.zeros((m, n), dtype=dt)
    t = np.zeros((n, n), dtype=dt)
    taus = np.zeros(n, dtype=dt)
    for j in range(n):
        beta, v, tau = _larfg(a[j:, j])
        taus[j] = tau
        a[j, j] = beta
        a[j + 1 :, j] = v[1:]
        v_full[j:, j] = v
        if tau != 0 and j + 1 < n:
            w = v @ a[j:, j + 1 :]
            a[j:, j + 1 :] -= tau * np.outer(v, w)
        # incremental T (xLARFT forward columnwise)
        if j == 0:
            t[0, 0] = tau
        else:
            z = v_full[:, :j].T @ v_full[:, j]
            t[:j, j] = -tau * (t[:j, :j] @ z)
            t[j, j] = tau
    return a, t


def unpack_v(packed: np.ndarray, n: int | None = None) -> np.ndarray:
    """Extract the unit-lower-trapezoidal V from packed GEQRT output."""
    m = packed.shape[0]
    n = packed.shape[1] if n is None else n
    v = np.tril(packed[:, :n], -1)
    v[np.arange(n), np.arange(n)] = 1
    return v


def larfb(packed: np.ndarray, t: np.ndarray, c: np.ndarray, trans: bool = True) -> np.ndarray:
    """C2 LARFB: C ← (I - V T V^T)^{T if trans} · C, V from packed GEQRT out.

    trans=True applies Q^T (factorization direction), trans=False applies Q
    (used by ORGQR / apply_q forward).
    """
    v = unpack_v(packed)
    tt = t.T if trans else t
    w = tt @ (v.T @ c)
    return c - v @ w


def tsqrt(r: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """C3 TSQRT: QR of the couple [R; B], R n×n upper-triangular, B m×n dense.

    Returns (r_out, v2, t2): the updated R, the dense m×n V2 block (the full
    structured reflector is V = [I; V2]), and the n×n compact-WY T2.
    """
    r = np.array(r, copy=True)
    b = np.array(b, copy=True)
    m, n = b.shape
    dt = r.dtype
    v2 = np.zeros((m, n), dtype=dt)
    t2 = np.zeros((n, n), dtype=dt)
    for j in range(n):
        x = np.concatenate(([r[j, j]], b[:, j]))
        beta, v, tau = _larfg(x)
        r[j, j] = beta
        v2[:, j] = v[1:]
        b[:, j] = 0
        if tau != 0 and j + 1 < n:
            # structured update: reflector touches row j of R and all of B
            w = r[j, j + 1 :] + v2[:, j] @ b[:, j + 1 :]
            r[j, j + 1 :] -= tau * w
            b[:, j + 1 :] -= tau * np.outer(v2[:, j], w)
        if j == 0:
            t2[0, 0] = tau
        else:
            z = v2[:, :j].T @ v2[:, j]
            t2[:j, j] = -tau * (t2[:j, :j] @ z)
            t2[j, j] = tau
    return r, v2, t2


def ssrfb(
    v2: np.ndarray, t2: np.ndarray, c_top: np.ndarray, c_bot: np.ndarray, trans: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """C4 SSRFB/TSMQR: apply the TSQRT couple reflector to [C_top; C_bot].

    [C_top; C_bot] ← (I - Ṽ T2 Ṽ^T)^{T if trans} [C_top; C_bot], Ṽ = [I; V2].
    Top-block update is matmul-free (SURVEY.md §2.2):
      W = T2^{T?} (C_top + V2^T C_bot);  C_top -= W;  C_bot -= V2 W.
    """
    tt = t2.T if trans else t2
    w = tt @ (c_top + v2.T @ c_bot)
    return c_top - w, c_bot - v2 @ w


def ttqrt(r1: np.ndarray, r2: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """C5 TTQRT: triangle-on-triangle combine, QR of [R1; R2] both upper-tri.

    Returns (r_out, v2, t2) with V2 upper-triangular (the TT structure —
    column j of the stacked reflector is nonzero only in rows 0..j of R2).
    Same recurrence as TSQRT; the triangular zero pattern of R2 is preserved
    by the updates, so the generic couple recurrence yields the TT result.
    """
    return tsqrt(r1, r2)


def ttmqr(
    v2: np.ndarray, t2: np.ndarray, c_top: np.ndarray, c_bot: np.ndarray, trans: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """C5 TTMQR: apply a TTQRT reflector pair — SSRFB with triangular V2."""
    return ssrfb(v2, t2, c_top, c_bot, trans)
