"""Right-looking tiled QR driver (reference component C7, SURVEY.md §3.1).

The reference drives the tile DAG with a host loop launching CUDA kernels on
streams with events + lookahead [BASELINE.json:5]. Here the panel loop is a
Python loop unrolled inside one ``jax.jit`` (``qr_tiled``): per panel, the
plain tile ops of kernels/tile_ops.py factor the panel column (GEQRT + TSQRT
couples) and apply its reflectors to the trailing columns (LARFB + SSRFB
GEMMs), and XLA schedules the whole program. The matrix buffer is updated in
place by ``dynamic_update_slice``.

Every panel of the unrolled driver has its own shapes and is compiled on its
own, so its compile grows with the panel count (PERF.md). Past
``STATIC_MAX_PANELS`` the api takes ``qr_tiled_loop``: the same chunk=0 tile
algebra in a ``lax.fori_loop`` over the panels of each of a few segments.
A segment's panels all work on the segment's (static) trailing block, with
the panel's diagonal tile at a runtime row (tile_ops.panel_factor_at /
panel_apply_at), so one panel body is compiled per segment. The price is the
work on the block's finished rows and columns: about 1 + 3/(2·segments)
times the update flops of a square matrix.

Couples (kernels/tile_ops.couple_bounds): the sub-diagonal of panel k is
eliminated in couples of ``chunk`` tiles. chunk=1 reproduces the reference's
flat-tree tile algebra exactly; chunk=0 eliminates the whole sub-diagonal in
one couple, which is blocked Householder QR with a tile-sized GEQRT on top.

Factor layout (QR factors of panel k):
  r_diag[k]: final diagonal R tile. t_geqrt[k]: compact-WY T of the GEQRT.
  panels[k] = (packed_kk, couples): packed_kk (nb, nb) is the packed GEQRT
  tile; couples is a tuple of (V2 (rows, nb), T2 (nb, nb)) top-down. A's
  upper triangle holds the off-diagonal R tiles; its sub-diagonal content
  is unspecified.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from tileqr.kernels.common import resolve_precision
from tileqr.kernels.tile_ops import (
    ix,
    panel_apply,
    panel_apply_at,
    panel_factor,
    panel_factor_at,
    stack_get,
    stack_put,
)

# Panel counts above this take the loop driver (api.qr_factor).
STATIC_MAX_PANELS = 32
# Segments of the loop drivers: one compiled panel body each.
LOOP_SEGMENTS = 16


@functools.partial(jax.jit, static_argnames=("nb", "chunk", "precision"))
def qr_tiled(a: jnp.ndarray, nb: int, chunk: int = 0, precision: str = "highest"):
    """Factor A (M, N; multiples of nb) in place.

    Returns (a, r_diag, t_geqrt, panels) in the module-docstring layout.
    """
    prec = resolve_precision(precision)
    m, n = a.shape
    mt, nt = m // nb, n // nb
    r_diag, t_geqrt, panels = [], [], []
    for k in range(min(mt, nt)):
        s = k * nb
        r_k, packed, tg, couples = panel_factor(a[s:, s : s + nb], nb, chunk, prec)
        r_diag.append(r_k)
        t_geqrt.append(tg)
        panels.append((packed, couples))
        if k + 1 < nt:
            win = panel_apply(packed, tg, couples, a[s:, s + nb :], True, prec)
            a = jax.lax.dynamic_update_slice(a, win, (s, s + nb))
    return a, jnp.stack(r_diag), jnp.stack(t_geqrt), tuple(panels)


def assemble_r(packed: jnp.ndarray, r_diag: jnp.ndarray, nb: int) -> jnp.ndarray:
    """R = triu(packed) with the stale diagonal tiles replaced by r_diag."""
    m, n = packed.shape
    mt, nt = m // nb, n // nb
    k_max = min(mt, nt)
    r = jnp.triu(packed)
    rt = r.reshape(mt, nb, nt, nb)
    idx = jnp.arange(k_max)
    rt = rt.at[idx, :, idx, :].set(jax.vmap(jnp.triu)(r_diag))
    return rt.reshape(m, n)


@functools.partial(
    jax.jit, static_argnames=("nb", "trans", "precision", "triangular")
)
def apply_q_tiled(
    panels: Tuple,
    t_geqrt: jnp.ndarray,
    c_mat: jnp.ndarray,
    nb: int,
    trans: bool = True,
    precision: str = "highest",
    triangular: bool = False,
):
    """C ← Qᵀ C (trans) or Q C, replaying the tiled reflectors (LAPACK
    xORMQR semantics; SURVEY.md §3.4). c_mat: (M, P).

    triangular (trans=False only): LAPACK xORGQR's growing-window trick for
    C with eye-like column structure (column tile j zero below row tile j,
    as the identity is): in reverse panel order, panel k is an EXACT no-op
    on column tiles < k — W = VᵀC sums over all-zero rows — so each panel's
    sweep starts at column tile k, halving the Q-formation flops. Only valid
    for such C (api.orgqr); a general C must use the full sweep.
    """
    if triangular and trans:
        raise ValueError("triangular window applies to Q·C only")
    prec = resolve_precision(precision)
    p = c_mat.shape[1]
    ks = range(len(panels)) if trans else range(len(panels) - 1, -1, -1)
    for k in ks:
        s = k * nb
        cs = s if triangular else 0  # first column this panel touches
        if cs >= p:
            # the growing window starts right of C's last column: the panel
            # is an exact no-op on the eye-structured C
            continue
        packed, couples = panels[k]
        win = panel_apply(packed, t_geqrt[k], couples, c_mat[s:, cs:], trans, prec)
        c_mat = jax.lax.dynamic_update_slice(c_mat, win, (s, cs))
    return c_mat


def loop_segments(k_max: int, segments: int = LOOP_SEGMENTS):
    """Panel ranges [ks, ke) of the loop drivers: near-equal, and of at least
    two panels each where there are two."""
    s = max(1, min(segments, k_max // 2))
    b = [round(i * k_max / s) for i in range(s + 1)]
    return tuple((b[i], b[i + 1]) for i in range(s))


class PanelStack(NamedTuple):
    """Reflectors of ``qr_tiled_loop``: packed (K, nb, nb) GEQRT tiles,
    t2 (K, nb, nb) couple T factors, and per segment [ks, ke) the couples'
    V2 (ke − ks, h − nb, nb) in rolled rows, h = M − ks·nb (row 0 is the row
    below the panel's diagonal tile; zeros past the matrix's end)."""

    packed: jnp.ndarray
    t2: jnp.ndarray
    v2: Tuple[jnp.ndarray, ...]
    segs: Tuple[Tuple[int, int], ...]


jax.tree_util.register_pytree_node(
    PanelStack,
    lambda p: ((p.packed, p.t2, p.v2), p.segs),
    lambda segs, ch: PanelStack(*ch, segs),
)


@functools.partial(jax.jit, static_argnames=("nb", "segments", "precision"))
def qr_tiled_loop(a, nb: int, segments: int = LOOP_SEGMENTS, precision: str = "highest"):
    """``qr_tiled`` with chunk=0 as a ``fori_loop`` over each segment's
    panels. Returns (a, r_diag, t_geqrt, PanelStack); a and r_diag as
    ``qr_tiled``'s."""
    prec = resolve_precision(precision)
    m, n = a.shape
    k_max = min(m, n) // nb
    segs = loop_segments(k_max, segments)
    zero = jnp.zeros((k_max, nb, nb), a.dtype)
    bufs = (zero,) * 4  # r_diag, t_geqrt, packed, t2
    v2s = []
    for ks, ke in segs:
        s = ks * nb
        sub = a[s:, s:]
        h = sub.shape[0]

        def panel(k, carry, ks=ks, h=h):
            sub, bufs, v2 = carry
            o = (k - ks) * nb
            col = jax.lax.dynamic_slice(sub, ix(0, o), (h, nb))
            r, packed, tg, v2k, t2 = panel_factor_at(col, o, nb, prec)
            sub = panel_apply_at(packed, tg, v2k, t2, sub, o, True, prec)
            bufs = tuple(stack_put(b, x, k) for b, x in zip(bufs, (r, tg, packed, t2)))
            return sub, bufs, stack_put(v2, v2k, k - ks)

        v2 = jnp.zeros((ke - ks, h - nb, nb), a.dtype)
        sub, bufs, v2 = jax.lax.fori_loop(ks, ke, panel, (sub, bufs, v2))
        a = jax.lax.dynamic_update_slice(a, sub, ix(s, s))
        v2s.append(v2)
    r_diag, t_geqrt, packed, t2 = bufs
    return a, r_diag, t_geqrt, PanelStack(packed, t2, tuple(v2s), segs)


@functools.partial(jax.jit, static_argnames=("nb", "trans", "precision"))
def apply_q_loop(
    stack: PanelStack, t_geqrt, c_mat, nb: int, trans: bool = True,
    precision: str = "highest",
):
    """C ← Qᵀ C (trans) or Q C with the factors of ``qr_tiled_loop``, as a
    ``fori_loop`` over each segment's panels. c_mat: (M, P), M the padded
    rows of the factorization."""
    prec = resolve_precision(precision)
    order = range(len(stack.segs)) if trans else reversed(range(len(stack.segs)))
    for si in order:
        ks, ke = stack.segs[si]
        s = ks * nb

        def panel(i, sub, ks=ks, ke=ke, v2=stack.v2[si]):
            k = ks + i if trans else ke - 1 - i
            return panel_apply_at(
                stack_get(stack.packed, k), stack_get(t_geqrt, k), stack_get(v2, k - ks),
                stack_get(stack.t2, k), sub, (k - ks) * nb, trans, prec,
            )

        sub = jax.lax.fori_loop(0, ke - ks, panel, c_mat[s:])
        c_mat = jax.lax.dynamic_update_slice(c_mat, sub, ix(s, 0))
    return c_mat
