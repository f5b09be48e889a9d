"""Blocked QR with CholeskyQR2 panels + Householder reconstruction
(``QRConfig.square_method="hr"`` — the matmul-only panel algorithm).

The Householder panel (drivers/square.py) is a chain of latency-bound
column factorizations; this driver replaces it with matmuls:

  1. Panel factor:  (Q, R) = CholeskyQR2(panel) — gram + Cholesky +
     log-doubling inverse + matmul-only orthogonality correction
     (drivers/cholqr.py). NO per-column work on the tall panel at all.
  2. Reconstruction: recover the compact-WY form from Q alone
     (kernels/modlu.py — Ballard/Demmel/Grigori/Knight identity):
         Q_top − diag(d) = L1·U   (modified LU, the ONLY serial step,
                                   nb×nb regardless of panel height)
         L2 = Q_bot·U⁻¹           (one tall matmul)
         Y  = [L1; L2],  T = −U·diag(d)·L1⁻ᵀ   (small matmuls; triangular
                                   inverses via the log-doubling identity)
     giving I − Y·T·Yᵀ orthogonal with (I − Y T Yᵀ)[:, :nb]·(d∘R) = panel.
  3. Trailing update: C ← C − Y·(Tᵀ·(Yᵀ·C)) — three large GEMMs at the
     configured precision ("highest" for the ≤1e-6 gate).

Conditioning contract (CholeskyQR territory, same as drivers/cholqr.py):
the first gram/Cholesky requires cond(panel)²·eps ≲ 1, i.e. cond ≲ 1e3 in
fp32. Trailing panels of a Householder-reduced matrix inherit A's
conditioning (orthogonal updates preserve singular values of the trailing
Schur complement), so the practical contract is cond(A) ≲ 1e3; outside it,
use the default unconditionally-stable Householder path
(square_method="hh").

Factor layout: per-panel (Y_k, T_k) with Y_k (M_pad − k·nb, nb) unit lower
trapezoidal and T_k (nb, nb) upper triangular — the LAPACK GEQRT contract
on whole panels instead of tiles.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from tileqr.drivers.cholqr import _triu_inv_doubling, cholqr2_batched
from tileqr.kernels.common import acc_type, bdot_pair_rows, resolve_precision
from tileqr.kernels.modlu import modified_lu

def _dot(a, b, prec, dt):
    return jnp.dot(a, b, precision=prec, preferred_element_type=acc_type(dt)).astype(dt)


def _reconstruct_yt(q, lu, d, dt):
    """(Y, T) from the panel's orthonormal Q and its top-block modified LU.

    All matmuls pinned HIGHEST: Y/T define the factorization itself (the
    same argument as cholqr.py's Q1 note — a bf16 pass here pollutes the
    reflector space with an error the trailing updates cannot remove)."""
    hi = jax.lax.Precision.HIGHEST
    nb = lu.shape[0]
    eye = jnp.eye(nb, dtype=dt)
    l1 = jnp.tril(lu, -1) + eye
    u = jnp.triu(lu)
    # U⁻¹ and L1⁻ᵀ = (L1ᵀ)⁻¹: both upper triangular → log-doubling inverse
    # (matmul-only; U's pivots are in [1, 2] by the sign modification, so
    # the inverse is well-conditioned)
    uinv = _triu_inv_doubling(u[None], hi)[0]
    l1tinv = _triu_inv_doubling(jnp.transpose(l1)[None], hi)[0]
    l2 = _dot(q[nb:], uinv, hi, dt)
    y = jnp.concatenate([l1, l2], axis=0)
    t = -_dot(u * d[None, :], l1tinv, hi, dt)
    return y, t


# panel pipeline default: "fused" folds the Q formation and the R gram
# away (4 tall passes over the panel instead of 6 — see hr_panel_fused);
# "classic" is the straight cholqr2_batched → modified-LU composition the
# fused form was A/B'd against.
_PANEL_PIPELINE = "fused"


def hr_panel(panel, correction_iters: int = 2, stats: bool = False,
             pipeline: str | None = None):
    """Factor one (mk, nb) panel: returns (y (mk, nb), t (nb, nb),
    r (nb, nb) with the reconstruction signs folded in). stats=True appends
    the panel's CholeskyQR round-1 orthogonality defect ‖Q₁ᵀQ₁ − I‖_max —
    the hr breakdown signal (see cholqr2_batched)."""
    if (pipeline or _PANEL_PIPELINE) == "fused":
        return hr_panel_fused(panel, correction_iters, stats)
    dt = panel.dtype
    out = cholqr2_batched(
        panel[None], mode="reduced", precision="highest",
        correction_iters=correction_iters, stats=stats,
    )
    q, r = out[0][0], out[1][0]
    lu, d = modified_lu(q[: r.shape[0]])
    y, t = _reconstruct_yt(q, lu, d, dt)
    rk = d[:, None] * r
    return (y, t, rk, out[2]) if stats else (y, t, rk)


def hr_panel_fused(panel, correction_iters: int = 2, stats: bool = False):
    """hr panel with the minimal number of tall passes over the panel.

    The classic pipeline makes SIX passes over the panel: gram, Q₁ = P·S₁, the correction gram Q₁ᵀQ₁,
    Q = Q₁·W, R = QᵀP, and L2 = Q[nb:]·U⁻¹. Three of those are algebraically
    redundant given the nb×nb intermediates already in hand:

      - Q is never needed: modified-LU only reads Q_top = Q₁[:nb]·W (nb³),
        and Y's bottom is Q[nb:]·U⁻¹ = Q₁[nb:]·(W·U⁻¹) — fold the two nb×nb
        factors first and make ONE tall pass.
      - R = QᵀP = Wᵀ·(Q₁ᵀP) and Q₁ᵀP = S₁ᵀ·(PᵀP) = S₁ᵀ·G — pure nb³ off the
        gram.

    What stays measured: the correction gram E = Q₁ᵀQ₁ − I. Its algebraic
    twin S₁ᵀGS₁ − I misses Q₁'s own formation rounding — exactly the defect
    the correction round and the breakdown monitor exist to see.

    Four tall passes total (gram, Q₁, E, Y-bottom); the two reconstruction
    triangular inverses run as one B=2 log-doubling batch. Same contract
    and return layout as the classic pipeline."""
    from tileqr.drivers.cholqr import _up_half, potrf

    dt = panel.dtype
    hi = jax.lax.Precision.HIGHEST
    nb = panel.shape[1]
    eye = jnp.eye(nb, dtype=dt)
    g = bdot_pair_rows(panel[None], panel[None], hi)  # tall pass 1
    r1 = potrf(g)
    s1 = _triu_inv_doubling(r1, hi)[0]
    q1 = _dot(panel, s1, hi, dt)  # tall pass 2
    e = bdot_pair_rows(q1, q1, hi) - eye  # tall pass 3
    if stats:
        emax = jnp.where(
            jnp.any(jnp.isnan(e)), jnp.asarray(jnp.nan, dt),
            jnp.max(jnp.abs(e)),
        )
    # matmul-only second round (cholqr2_batched's algebra, B=1 inline):
    # chol(I+E) = I + U by the quadratic iteration, (I+U)⁻¹ by Horner
    u = _up_half(e[None])[0]
    for _ in range(correction_iters):
        u = _up_half((e - _dot(jnp.transpose(u), u, hi, dt))[None])[0]
    w = eye - u
    w = eye - _dot(u, w, hi, dt)
    w = eye - _dot(u, w, hi, dt)
    q_top = _dot(q1[:nb], w, hi, dt)
    lu, d = modified_lu(q_top)
    l1 = jnp.tril(lu, -1) + eye
    uu = jnp.triu(lu)
    invs = _triu_inv_doubling(jnp.stack([uu, jnp.transpose(l1)]), hi)
    uuinv, l1tinv = invs[0], invs[1]
    l2 = _dot(q1[nb:], _dot(w, uuinv, hi, dt), hi, dt)  # tall pass 4
    y = jnp.concatenate([l1, l2], axis=0)
    t = -_dot(uu * d[None, :], l1tinv, hi, dt)
    r = jnp.triu(_dot(jnp.transpose(w), _dot(jnp.transpose(s1), g[0], hi, dt), hi, dt))
    rk = d[:, None] * r
    return (y, t, rk, emax) if stats else (y, t, rk)


def _apply_block_t(y, t, c, prec, dt, trans: bool):
    """C ← (I − Y·T·Yᵀ)ᵀ C (trans) or (I − Y·T·Yᵀ) C (no trans).

    The projection W = YᵀC is where the apply's rounding error grows with
    the row count, so it accumulates pairwise over row blocks
    (kernels/common.bdot_pair_rows)."""
    w = bdot_pair_rows(y, c, prec)
    tm = jnp.transpose(t) if trans else t
    w = _dot(tm, w, prec, dt)
    return c - _dot(y, w, prec, dt)


@functools.partial(
    jax.jit,
    static_argnames=("nb", "precision", "barrier_every", "r_anchor", "stats"),
)
def qr_hr(
    ap,
    nb: int,
    precision: str = "highest",
    barrier_every: int = 8,
    r_anchor: str = "cholqr",
    stats: bool = False,
):
    """Blocked hr QR of a padded (Mp, Np) matrix (both multiples of nb;
    column padding must be identity-augmented — see pad_for_hr).

    r_anchor selects where panel k's R(k,k) diagonal block comes from:
      "cholqr" (default): CholeskyQR2's R (= triu(QᵀA) with the corrected Q,
        signs folded).
      "panel": apply the reconstructed block reflector to the panel's OWN
        columns and take triu of the top block — the hh driver's R
        materialization, at the cost of one extra nb-wide update strip.

    Returns (r (K, Np) with K = min(Mp, Np), panels tuple of (Y_k, T_k));
    stats=True appends ``health`` = max over panels of the CholeskyQR
    round-1 orthogonality defect (hr breakdown signal — NaN/huge on a
    panel whose cond²·eps ≳ 1; see cholqr2_batched). The (r, panels)
    outputs are bitwise-unchanged by stats (the defect is a pure
    observer reduce on an already-computed intermediate)."""
    mp, npad = ap.shape
    if mp % nb or npad % nb:
        raise ValueError(f"padded shape {ap.shape} not a multiple of nb={nb}")
    if r_anchor not in ("panel", "cholqr"):
        raise ValueError(f"r_anchor={r_anchor!r} must be panel|cholqr")
    dt = ap.dtype
    prec = resolve_precision(precision)
    k_max = min(mp, npad) // nb
    # R rows land in a preallocated buffer via dynamic_update_slice, NOT a
    # final concat of per-panel slices: the concat form keeps EVERY
    # trailing-matrix temp alive until the end (each contributes its first
    # nb rows), Σ(N−k·nb)² ≈ N³/(3nb) bytes. With the eager copy-out, only
    # two consecutive trailing matrices are ever live.
    r = jnp.zeros((k_max * nb, npad), dt)
    trail, r, panels, health = _hr_body(
        ap, r, nb, 0, k_max, prec, dt, barrier_every, r_anchor, stats=stats,
    )
    if stats:
        return r, tuple(panels), health
    return r, tuple(panels)


def _hr_body(trail, r, nb, k0, kseg, prec, dt, barrier_every, r_anchor,
             stats=False):
    """Factor panels [k0, k0+kseg) of ``trail`` (the trailing window whose
    top-left corner is global (k0·nb, k0·nb)), writing finished R rows into
    the full-width ``r`` buffer at their global offsets. Returns the
    remaining trailing window, the updated r, the panel list, and the
    running health max (None unless stats)."""
    panels = []
    health = None
    for i in range(kseg):
        k = k0 + i
        if stats:
            y, t, rk, emax = hr_panel(trail[:, :nb], stats=True)
            health = emax if health is None else jnp.maximum(health, emax)
        else:
            y, t, rk = hr_panel(trail[:, :nb])
        if r_anchor == "panel":
            c = _apply_block_t(y, t, trail, prec, dt, trans=True)
            row = jnp.concatenate([jnp.triu(c[:nb, :nb]), c[:nb, nb:]], axis=1)
            trail = c[nb:, nb:]
        else:
            c = _apply_block_t(y, t, trail[:, nb:], prec, dt, trans=True)
            row = jnp.concatenate([rk, c[:nb]], axis=1)
            trail = c[nb:]
        r = jax.lax.dynamic_update_slice(r, row, (k * nb, k * nb))
        # every ``barrier_every`` panels, pin the R-row copy-outs BEFORE the
        # next panel starts: the scheduler may otherwise defer all the small
        # R updates to the end, keeping every shrinking trailing temp alive
        # at once (Σ(N−k·nb)² ≈ N³/(3nb) bytes). A barrier on EVERY panel
        # would also serialize the panel/update overlap XLA can schedule.
        if (k + 1) % max(1, barrier_every) == 0:
            trail, r = jax.lax.optimization_barrier((trail, r))
        panels.append((y, t))
    return trail, r, panels, health


@functools.partial(
    jax.jit,
    static_argnames=("nb", "k0", "kseg", "precision", "barrier_every",
                     "r_anchor", "stats"),
    donate_argnums=(0,),
)
def _hr_segment(carry, nb, k0, kseg, precision, barrier_every, r_anchor,
                stats=False, health=None):
    """Factor panels [k0, k0+kseg) inside the full-size carry matrix. The
    carry is the SINGLE (Mp, Np) buffer and the ONLY loop state: finished R
    row blocks live at their global offsets (stale A values left of the
    diagonal — removed by the caller's final triu), the active trailing
    window at (k·nb, k·nb) is read through slices and written back per
    panel. Full-shape in/out keeps the donated carry aliasable (a shrinking
    trail output cannot alias its larger input), and the live set is carry
    + ONE window temp instead of carry + two evolving windows."""
    prec = resolve_precision(precision)
    dt = carry.dtype
    panels = []
    for i in range(kseg):
        k = k0 + i
        s = k * nb
        win = carry[s:, s:]
        if stats:
            y, t, rk, emax = hr_panel(win[:, :nb], stats=True)
            health = emax if health is None else jnp.maximum(health, emax)
        else:
            y, t, rk = hr_panel(win[:, :nb])
        if r_anchor == "panel":
            c = _apply_block_t(y, t, win, prec, dt, trans=True)
            row = jnp.concatenate([jnp.triu(c[:nb, :nb]), c[:nb, nb:]], axis=1)
            low = c[nb:, nb:]
        else:
            c = _apply_block_t(y, t, win[:, nb:], prec, dt, trans=True)
            row = jnp.concatenate([rk, c[:nb]], axis=1)
            low = c[nb:]
        carry = jax.lax.dynamic_update_slice(carry, row, (s, s))
        carry = jax.lax.dynamic_update_slice(carry, low, (s + nb, s + nb))
        if (k + 1) % max(1, barrier_every) == 0:
            carry = jax.lax.optimization_barrier(carry)
        panels.append((y, t))
    return carry, tuple(panels), health


def qr_hr_chunked(
    ap,
    nb: int,
    precision: str = "highest",
    seg_panels: int = 8,
    barrier_every: int = 2,
    r_anchor: str = "cholqr",
    stats: bool = False,
):
    """Bounded-compile hr driver: same algorithm and factor layout as
    ``qr_hr``, but the panel loop is split into ``seg_panels``-panel
    segments, each its OWN small jitted executable with the carry matrix
    donated between them. Compile cost is O(k_max / seg_panels) small
    programs instead of one k_max-panel program. No flop waste, no masking
    — shapes shrink at segment boundaries exactly as the static driver's
    do. R rides INSIDE the carry (row blocks at their global offsets) so
    the donated buffer aliases in/out at full shape; the final triu strips
    the stale below-diagonal values.

    DONATES ``ap`` (and reuses it as the carry) — callers keep their
    original unpadded array; ``pad_for_hr`` always allocates a fresh
    padded buffer. The returned (r, panels) are BITWISE-equal to ``qr_hr``
    (pinned by test)."""
    mp, npad = ap.shape
    if mp % nb or npad % nb:
        raise ValueError(f"padded shape {ap.shape} not a multiple of nb={nb}")
    k_max = min(mp, npad) // nb
    carry = ap
    panels = []
    k0 = 0
    # health folds INSIDE each segment executable (one jnp.maximum chain per
    # segment, seeded with 0 so every segment shares one jit signature)
    health = jnp.zeros((), ap.dtype) if stats else None
    while k0 < k_max:
        kseg = min(seg_panels, k_max - k0)
        carry, seg, health = _hr_segment(
            carry, nb=nb, k0=k0, kseg=kseg, precision=precision,
            barrier_every=barrier_every, r_anchor=r_anchor, stats=stats,
            health=health,
        )
        panels.extend(seg)
        k0 += kseg
    # Donation pays only when R has the carry's shape (square input after
    # padding): XLA reuses the carry's buffer for R. For rectangular inputs
    # the alias is impossible, and a donated jit would only warn on every
    # call — take the undonated twin.
    square = k_max * nb == mp
    r = (_finish_r if square else _finish_r_nodonate)(carry, k_max * nb)
    if stats:
        return r, tuple(panels), health
    return r, tuple(panels)


def _finish_r_impl(carry, k_rows: int):
    return jnp.triu(carry[:k_rows])


_finish_r = jax.jit(_finish_r_impl, static_argnames=("k_rows",), donate_argnums=(0,))
_finish_r_nodonate = jax.jit(_finish_r_impl, static_argnames=("k_rows",))


@functools.partial(jax.jit, static_argnames=("nb", "trans", "precision"))
def apply_q_hr(
    panels: Tuple, c, nb: int, trans: bool = False, precision: str = "highest",
):
    """C ← Q C (or Qᵀ C) from hr factors. c: (Mp, P), Mp the padded rows."""
    dt = c.dtype
    prec = resolve_precision(precision)
    order = range(len(panels)) if trans else reversed(range(len(panels)))
    for k in order:
        y, t = panels[k]
        s = k * nb
        cs = _apply_block_t(y, t, c[s:], prec, dt, trans=trans)
        c = jnp.concatenate([c[:s], cs], axis=0) if s else cs
    return c


@functools.partial(
    jax.jit,
    static_argnames=("nb", "k0", "trans", "precision"),
    donate_argnums=(1,),
)
def _apply_segment(panels, c, nb, k0, trans, precision):
    dt = c.dtype
    prec = resolve_precision(precision)
    order = range(len(panels)) if trans else reversed(range(len(panels)))
    for i in order:
        y, t = panels[i]
        s = (k0 + i) * nb
        cs = _apply_block_t(y, t, c[s:], prec, dt, trans=trans)
        c = jnp.concatenate([c[:s], cs], axis=0) if s else cs
    return c


def apply_q_hr_chunked(
    panels: Tuple, c, nb: int, trans: bool = False,
    precision: str = "highest", seg_panels: int = 8,
):
    """Bounded-compile twin of ``apply_q_hr``: the panel loop is cut into
    ``seg_panels``-panel jitted segments with the target donated between
    them. Segments run forward for Qᵀ (trans) and reversed for Q. Same
    values as apply_q_hr (identical op sequence, just cut at jit
    boundaries). DONATES ``c`` — callers pass a fresh target (api.apply_q
    pads into one)."""
    k_max = len(panels)
    bounds = list(range(0, k_max, seg_panels)) + [k_max]
    segs = list(zip(bounds[:-1], bounds[1:]))
    if not trans:
        segs = list(reversed(segs))
    for ks, ke in segs:
        c = _apply_segment(
            tuple(panels[ks:ke]), c, nb=nb, k0=ks, trans=trans,
            precision=precision,
        )
    return c


@functools.partial(jax.jit, static_argnames=("mp", "nb", "ncols", "precision"))
def orgqr_hr(
    panels: Tuple, mp: int, nb: int, ncols: int, precision: str = "highest",
):
    """Form Q (Mp × ncols) with the xORGQR growing window: accumulating in
    reverse panel order, panel k only touches rows/columns ≥ k·nb (columns
    left of the panel are still exact unit vectors, on which Yᵀe_c = 0), so
    the working window grows from the last panel's corner instead of
    carrying the full matrix through every panel."""
    dt = panels[0][0].dtype
    prec = resolve_precision(precision)
    # panels at or beyond ncols are exact no-ops on Q's columns
    k_used = min(len(panels), -(-ncols // nb))
    s_last = (k_used - 1) * nb
    w = jnp.eye(mp - s_last, ncols - s_last, dtype=dt)
    w = _apply_block_t(*panels[k_used - 1], w, prec, dt, trans=False)
    for k in reversed(range(k_used - 1)):
        rows, cols = w.shape
        w = jnp.block(
            [
                [jnp.eye(nb, dtype=dt), jnp.zeros((nb, cols), dt)],
                [jnp.zeros((rows, nb), dt), w],
            ]
        )
        w = _apply_block_t(*panels[k], w, prec, dt, trans=False)
    return w


def pad_for_hr(a, nb: int, row_mult: int | None = None, col_mult: int | None = None):
    """Pad (M, N) to nb multiples for the hr driver. Zero ROW padding is
    exact (zero rows contribute nothing to panel grams). Zero COLUMN padding
    would make the last panel's gram singular, so padded columns carry an
    α·identity block on otherwise-zero padding rows (α an exact power of two
    near max|A|): the gram becomes block-diagonal and well-conditioned, the
    padded columns factor to exact unit reflectors, and R's real block is
    untouched (later columns never influence earlier panels).

    row_mult/col_mult override the padding multiples (default nb both) —
    the sharded hr driver pads to nb·pr / nb·pc so the block-cyclic local
    matrices are uniform across the mesh."""
    from tileqr.core.layout import round_up

    m, n = a.shape
    np_ = round_up(n, col_mult or nb)
    col_pad = np_ - n
    mp = round_up(m + col_pad, row_mult or nb) if col_pad else round_up(m, row_mult or nb)
    ap = jnp.pad(a, ((0, mp - m), (0, col_pad)))
    if col_pad:
        amax = jnp.max(jnp.abs(a))
        alpha = jnp.where(
            amax > 0,
            jnp.exp2(
                jnp.minimum(
                    jnp.ceil(jnp.log2(jnp.maximum(amax, jnp.finfo(a.dtype).tiny))),
                    float(jnp.finfo(a.dtype).maxexp - 1),
                )
            ),
            jnp.ones((), a.dtype),
        ).astype(a.dtype)
        rows = jnp.arange(mp)[:, None]
        cols = jnp.arange(np_)[None, :]
        ap = jnp.where(
            (cols >= n) & (rows == cols - n + m), alpha, ap
        )
    return ap, (m, n)
