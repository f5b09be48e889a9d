"""Tile operations of the tiled QR (reference components C1–C5) in plain XLA.

The reference runs each tile operation as its own CUDA kernel
[SURVEY.md §2.1, BASELINE.json:5]. Here every operation is a short chain of
library calls that XLA emits on the GPU:

  * GEQRT/TSQRT/TTQRT — Householder QR of a tile or of a stacked couple
    [R; B] through geqrf (``_geqrf``: cuSOLVER geqrf on the GPU, LAPACK on
    the CPU). The couple's reflector block is [I; V2] because R's
    strict lower part is zero, which geqrf keeps exactly zero.
  * the compact-WY factor T — one triangular solve on the Gram matrix
    (``build_t``), no per-column recurrence.
  * LARFB/SSRFB/TTMQR — reflector applications as GEMMs at an explicit
    precision (cuBLAS SGEMM at ``HIGHEST``).

All ops take optional leading batch axes. Output contracts are those of
ref/tile_ops.py: packed storage (R on/above the diagonal, unit-diagonal V
below), T upper triangular with Q = I − V T Vᵀ, LAPACK xLARFG signs.

``panel_factor``/``panel_apply`` compose them into one panel column of the
tiled algorithm: GEQRT of the diagonal tile, then TSQRT couples of ``chunk``
sub-diagonal tiles each (chunk=1 is the reference's flat tile tree; chunk=0
folds the whole sub-diagonal into one couple per panel).
``panel_factor_at``/``panel_apply_at`` are the chunk=0 panel at a runtime
row offset, for the loop drivers.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from tileqr.kernels.common import (
    HIGHEST,
    _rows_cols,
    acc_type,
    bdot_pair_rows,
    dot,
    triu,
    unit_lower,
)


def _geqrf(a):
    """LAPACK-style geqrf: (packed (…, m, n), τ (…, min(m, n))). Reached
    through ``jnp.linalg.qr(mode="raw")``, which returns the packed factor
    transposed (numpy's convention); the two transposes cancel in XLA.
    bfloat16 tiles are factored in float32 (the solvers take no 16-bit
    types) and rounded back."""
    h, taus = jnp.linalg.qr(a.astype(acc_type(a.dtype)), mode="raw")
    return jnp.swapaxes(h, -1, -2).astype(a.dtype), taus.astype(a.dtype)


def build_t(g, taus):
    """Compact-WY T from the reflectors' Gram matrix G = VᵀV (…, k, k) and
    τ (…, k): T⁻¹ = striu(G) + diag(1/τ), which is the xLARFT recurrence
    T[:j, j] = −τ_j T[:j, :j] (V[:, :j]ᵀ v_j) solved in one triangular solve.

    A τ = 0 reflector (a column already zero below its diagonal — every
    zero-padded column is one) is the identity, and its row and column of T
    are zero. The inverse form has no 1/0, so such a column is decoupled
    (its Gram row/column zeroed, diagonal 1), solved, and zeroed after."""
    out_dt = g.dtype
    g = g.astype(acc_type(out_dt))
    taus = taus.astype(g.dtype)
    dt = g.dtype
    live = taus != 0
    both = live[..., :, None] & live[..., None, :]
    rows, cols = _rows_cols(g.shape)
    inv_tau = jnp.where(live, 1 / jnp.where(live, taus, jnp.ones((), dt)), 1)
    tinv = jnp.where((rows < cols) & both, g, jnp.zeros((), dt))
    tinv = tinv + jnp.where(rows == cols, inv_tau[..., None, :], jnp.zeros((), dt))
    eye = jnp.broadcast_to(jnp.eye(g.shape[-1], dtype=dt), g.shape)
    t = jax.lax.linalg.triangular_solve(tinv, eye, left_side=True, lower=False)
    return jnp.where(both, t, jnp.zeros((), dt)).astype(out_dt)


def geqrt(a, precision=HIGHEST):
    """C1 GEQRT: a (…, m, n) → (packed (…, m, n), T (…, k, k)), k = min(m, n)."""
    packed, taus = _geqrf(a)
    k = taus.shape[-1]
    v = unit_lower(packed[..., :, :k])
    return packed, build_t(bdot_pair_rows(v, v, precision), taus)


def tsqrt(r, b, precision=HIGHEST):
    """C3 TSQRT: QR of the couple [R; B], R (…, n, n) upper triangular,
    B (…, m, n). Returns (R', V2 (…, m, n), T2 (…, n, n)); the couple's
    reflector block is [I; V2]."""
    n = r.shape[-1]
    packed, taus = _geqrf(jnp.concatenate([r, b], axis=-2))
    v2 = packed[..., n:, :]
    eye = jnp.eye(n, dtype=r.dtype)
    t2 = build_t(eye + bdot_pair_rows(v2, v2, precision), taus)
    return triu(packed[..., :n, :]), v2, t2


def ttqrt(r1, r2, precision=HIGHEST):
    """C5 TTQRT: TSQRT of two upper-triangular factors. V2 inherits R2's
    upper-triangular structure (its strict lower part is set to exact
    zeros)."""
    r, v2, t2 = tsqrt(r1, r2, precision)
    return r, triu(v2), t2


def larfb(packed, t, c, trans: bool = True, precision=HIGHEST):
    """C2 LARFB: C ← (I − V T Vᵀ)^{T if trans} C with V = unit_lower(packed)."""
    v = unit_lower(packed)
    w = bdot_pair_rows(v, c, precision)
    w = bdot_pair_rows(t, w, precision) if trans else dot(t, w, precision)
    return c - dot(v, w, precision)


def ssrfb(v2, t2, c_top, c_bot, trans: bool = True, precision=HIGHEST):
    """C4 SSRFB (and C5 TTMQR): apply the couple reflector [I; V2] to
    [C_top; C_bot]. Returns (C_top', C_bot')."""
    w = c_top + bdot_pair_rows(v2, c_bot, precision)
    w = bdot_pair_rows(t2, w, precision) if trans else dot(t2, w, precision)
    return c_top - w, c_bot - dot(v2, w, precision)


ttmqr = ssrfb


def couple_bounds(n_sub: int, chunk: int):
    """Sub-diagonal tile ranges [i0, i1) of a panel's couples: ``chunk``
    tiles each from the top, the last one ragged; chunk <= 0 → one couple."""
    if n_sub <= 0:
        return []
    c = n_sub if chunk <= 0 else chunk
    return [(i, min(i + c, n_sub)) for i in range(0, n_sub, c)]


def panel_factor(pcol, nb: int, chunk: int, precision=HIGHEST):
    """Factor one panel column pcol (h, nb), h a multiple of nb: GEQRT of the
    top tile, then the TSQRT couple chain over the rest.

    Returns (r (nb, nb), packed (nb, nb), tg (nb, nb), couples) with couples
    a tuple of (V2 (rows, nb), T2 (nb, nb)) in elimination order."""
    packed, tg = geqrt(pcol[:nb], precision)
    r = triu(packed)
    couples = []
    for i0, i1 in couple_bounds(pcol.shape[0] // nb - 1, chunk):
        r, v2, t2 = tsqrt(r, pcol[(1 + i0) * nb : (1 + i1) * nb], precision)
        couples.append((v2, t2))
    return r, packed, tg, tuple(couples)


def panel_apply(packed, tg, couples: Tuple, c, trans: bool, precision=HIGHEST):
    """Apply one panel's reflectors to c (h, p), whose rows align with the
    factored panel column. trans=True applies Qᵀ in factor order (LARFB,
    then the couples top-down); trans=False applies Q in reverse. Returns
    the updated (h, p) block."""
    nb = packed.shape[0]
    bounds = []
    row = nb
    for v2, _ in couples:
        bounds.append((row, row + v2.shape[0]))
        row += v2.shape[0]
    strip = c[:nb]
    bots = [None] * len(couples)
    if trans:
        strip = larfb(packed, tg, strip, True, precision)
        for i, ((v2, t2), (r0, r1)) in enumerate(zip(couples, bounds)):
            strip, bots[i] = ssrfb(v2, t2, strip, c[r0:r1], True, precision)
    else:
        for i in reversed(range(len(couples))):
            (v2, t2), (r0, r1) = couples[i], bounds[i]
            strip, bots[i] = ssrfb(v2, t2, strip, c[r0:r1], False, precision)
        strip = larfb(packed, tg, strip, False, precision)
    return jnp.concatenate([strip] + bots, axis=0) if bots else strip


# The loop drivers (drivers/square.qr_tiled_loop, drivers/sharded.py) run one
# compiled panel body for every panel of a segment, so a panel's diagonal tile
# sits at a RUNTIME row o of a fixed-height block. Its couple is then carried
# in "rolled" rows: row 0 is the diagonal tile, rows past the block's end are
# zeros, which Householder leaves zero (τ-free rows of V stay exactly 0).


def ix(*xs):
    """int32 index tuple for dynamic slices (python ints would promote to
    int64 beside int32 tracers under x64)."""
    return tuple(jnp.asarray(x, jnp.int32) for x in xs)


def stack_put(buf, x, i):
    """buf with x written at index i of its leading axis."""
    return jax.lax.dynamic_update_slice(buf, x[None].astype(buf.dtype), ix(i, *([0] * x.ndim)))


def stack_get(buf, i):
    """buf[i] at a runtime index i."""
    return jax.lax.dynamic_index_in_dim(buf, i, keepdims=False)


def rows_from(x, o):
    """Rows o… of x (h, w), zero-extended to h rows."""
    return jax.lax.dynamic_slice(jnp.concatenate([x, jnp.zeros_like(x)]), ix(o, 0), x.shape)


def rows_at(y, o):
    """Inverse of ``rows_from``: y (h, w) moved down to start at row o, zeros
    above (its last o rows, which must be zero, drop out)."""
    h = y.shape[0]
    return jax.lax.dynamic_slice(jnp.concatenate([jnp.zeros_like(y), y]), ix(h - o, 0), y.shape)


def panel_factor_at(col, o, nb: int, precision=HIGHEST):
    """Factor the panel whose diagonal tile is at row o of col (h, nb); rows
    above o are finished and ignored. GEQRT of the diagonal tile, then one
    TSQRT couple over every row below it. Returns (r, packed, tg, v2, t2)
    with v2 (h − nb, nb) in rolled rows."""
    r, packed, tg, couples = panel_factor(rows_from(col, o), nb, 0, precision)
    if not couples:  # h == nb: nothing below the diagonal tile
        zero = jnp.zeros((nb, nb), col.dtype)
        return r, packed, tg, jnp.zeros((0, nb), col.dtype), zero
    (v2, t2), = couples
    return r, packed, tg, v2, t2


def panel_apply_at(packed, tg, v2, t2, c, o, trans: bool, precision=HIGHEST):
    """``panel_apply`` for a panel from ``panel_factor_at`` whose diagonal
    tile is at row o of c (h, p). The couple [I; V2] is applied as one
    full-height block that is zero above row o, so rows above o are left
    exactly as they are."""
    nb = packed.shape[0]
    y = rows_at(jnp.concatenate([jnp.eye(nb, dtype=v2.dtype), v2]), o)

    def couple(c):
        w = bdot_pair_rows(y, c, precision)
        w = bdot_pair_rows(t2, w, precision) if trans else dot(t2, w, precision)
        return c - dot(y, w, precision)

    if not trans:
        c = couple(c)
    strip = jax.lax.dynamic_slice(c, ix(o, 0), (nb, c.shape[1]))
    c = jax.lax.dynamic_update_slice(c, larfb(packed, tg, strip, trans, precision), ix(o, 0))
    return couple(c) if trans else c
