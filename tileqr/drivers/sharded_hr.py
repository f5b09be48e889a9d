"""Gram-panel 2D block-cyclic sharded QR — CholeskyQR2 panels + Householder
reconstruction over the mesh (``QRConfig(square_method="hr")`` routed through
``qr_sharded``).

Rationale. The Householder sharded driver (drivers/sharded.py) reduces each
panel with a TTQRT tree across mesh rows: log2(pr) R-tile ppermute
exchanges at factor time plus log2(pr) full-width strip PAIR exchanges
(both directions) at update time. This driver is the communication-minimal
alternative — the gram is the communication-optimal cross-device reduction
(Σ RᵢᵀRᵢ = AᵀA is what the whole TTQRT tree computes) — applied per panel
of a square/rectangular factorization:

  1. panel column broadcast along 'cols' (masked psum, as the HH drivers);
  2. distributed CholeskyQR2: G = psum_rows(PᵀP) (one nb² collective),
     POTRF + triangular inverse REPLICATED (nb³ work, drivers/cholqr.py),
     Q local; the orthogonality-correction
     round costs one more nb² psum;
  3. Householder reconstruction (kernels/modlu.py, as drivers/square_hr.py):
     the diagonal owner's top block is psum-broadcast (nb²), modified LU +
     (U⁻¹, T) are computed replicated, Y = (Q − diag d)·U⁻¹ local — the
     whole-panel compact-WY factors with NO per-column work anywhere;
  4. trailing update C ← C − Y·(Tᵀ·(Yᵀ·C)): one psum_rows of the nb-row
     projection W = YᵀC (the only full-width collective — vs the HH strip
     tree's 2·log2(pr) strip hops), two local GEMMs at the configured
     precision.

Per-panel cross-chip traffic: 1 column psum + 3 nb² psums + 1 nb-row-strip
psum. No ppermute, no lax.switch rotation branches: every shape is k-independent within a segment (window expressed as a row
mask), so ``lax.fori_loop`` compiles ONE executable for any panel count —
bounded compile for free.

Zero-row masking replaces window shapes: local rows above the panel window
(finalized R rows) get Y-rows of exact zeros, so the update provably leaves
them untouched, and below-window junk columns receive junk (discarded by
the triu in assemble). The flop overhead of full-extent updates is bounded
by SEGMENTING the panel loop INSIDE the shard_map body: the k range splits
into ``segments`` statically-shrinking local windows (the block-cyclic
layout makes the remaining global window a contiguous local tail on every
device, up to one tile of raggedness the mask absorbs), so the waste
integrates to ~1 + 3/(2·segments) for square matrices instead of 3x.

Conditioning contract: CholeskyQR territory (drivers/square_hr.py) —
cond(A) ≲ 1e3 in fp32. Outside it, use the unconditionally stable
Householder sharded drivers.

Reference mapping: the reference is single-GPU (SURVEY.md §2.3); this is a
build-side extension of the BASELINE.json:5 "Add … 2D block-cyclic
sharding" item, with the hr panel algorithm of drivers/square_hr.py.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from tileqr.core.config import QRConfig
from tileqr.core.layout import round_up
from tileqr.drivers.cholqr import _triu_inv_doubling, _up_half, potrf
from tileqr.drivers.sharded import (
    SEGMENTS,
    _to_local_layout,
    _unpack_local_jit,
    make_mesh,
    mesh_from_factors,
)
from tileqr.drivers.square_hr import _dot, pad_for_hr
from tileqr.kernels.common import bdot_pair_rows, resolve_precision
from tileqr.kernels.modlu import modified_lu
from tileqr.kernels.tile_ops import ix

_HI = jax.lax.Precision.HIGHEST


class ShardedHRFactors(NamedTuple):
    """Distributed whole-panel compact-WY factors (gram-panel hr driver).

    local: (pr, pc, lm, ln) updated local matrices (sharded; R rows/strips
    in place, junk below the diagonal).
    r_diag: (k_max, nb, nb) final diagonal R tiles (replicated).
    t_all: (k_max, nb, nb) upper-triangular T factors (replicated).
    y_segs: per-segment Y buffers, each (pr, ke−ks, h_s, nb) — panel k's
    local Y rows for the segment's sliced window (sharded over 'rows',
    replicated along 'cols'; zero above the panel's window).
    segs: static ((ks, ke, lr, lc), …) segment table (panel range + local
    row/col tile starts of the segment's slice).
    health: replicated scalar (or None when QRConfig.hr_guard="off") — max
    over panels of the CholeskyQR round-1 orthogonality defect, the same
    breakdown monitor as the single-chip hr path (api.HRFactors.health)."""

    local: jnp.ndarray
    r_diag: jnp.ndarray
    t_all: jnp.ndarray
    y_segs: Tuple[jnp.ndarray, ...]
    nb: int
    shape: Tuple[int, int]
    grid: Tuple[int, int, int, int]  # (mt, nt, pr, pc)
    segs: Tuple[Tuple[int, int, int, int], ...]
    health: object = None


jax.tree_util.register_pytree_node(
    ShardedHRFactors,
    lambda f: ((f.local, f.r_diag, f.t_all, f.y_segs, f.health),
               (f.nb, f.shape, f.grid, f.segs)),
    lambda aux, ch: ShardedHRFactors(ch[0], ch[1], ch[2], ch[3], *aux, ch[4]),
)


def _cholqr2_psum(p, nb: int, correction_iters: int = 2):
    """Distributed CholeskyQR2 of one panel, rows sharded over 'rows' —
    the FUSED form (square_hr.hr_panel_fused ported across the mesh).

    p: (lm, nb) local rows (masked: zeros outside the window). Returns
    (q1 local rows, w replicated, R replicated, emax replicated): Q is
    NEVER materialized — callers fold W into whatever they apply to Q₁
    (top-block extract, Y reconstruction), and R = Wᵀ·S₁ᵀ·G comes off the
    already-replicated gram at nb³ cost, deleting BOTH the Q-formation
    local tall pass and the R-gram's nb² psum (2 collectives per panel
    instead of 3 here). All matmuls HIGHEST — the factors define the
    factorization (drivers/cholqr.py Q1 precision note). The LOCAL tall
    contractions accumulate pairwise (common.bdot_pair_rows) for the same √m
    reason as the single-device cholqr2; the psum across 'rows' is already
    a device-level tree."""
    dt = p.dtype
    eye = jnp.eye(nb, dtype=dt)
    g = jax.lax.psum(bdot_pair_rows(p, p, _HI), "rows")
    r1 = potrf(g[None])[0]
    s1 = _triu_inv_doubling(r1[None], _HI)[0]
    q1 = _dot(p, s1, _HI, dt)
    # matmul-only orthogonality correction (one nb² psum for the measured
    # round-1 gram — it must SEE Q₁'s formation rounding, so no algebraic
    # S₁ᵀGS₁ shortcut here; the iteration itself is replicated nb³ work)
    e = jax.lax.psum(bdot_pair_rows(q1, q1, _HI), "rows") - eye
    # breakdown monitor (replicated — e is post-psum): NaN-propagating max
    # of the round-1 defect, the same signal as cholqr2_batched(stats=True)
    emax = jnp.where(
        jnp.any(jnp.isnan(e)), jnp.asarray(jnp.nan, dt), jnp.max(jnp.abs(e))
    )
    u = _up_half(e[None])[0]
    for _ in range(correction_iters):
        u = _up_half((e - _dot(jnp.transpose(u), u, _HI, dt))[None])[0]
    w = eye - u
    w = eye - _dot(u, w, _HI, dt)
    w = eye - _dot(u, w, _HI, dt)
    r = jnp.triu(_dot(jnp.transpose(w), _dot(jnp.transpose(s1), g, _HI, dt), _HI, dt))
    return q1, w, r, emax


def _reconstruct_yt_dist(q1, w, lu, d, top_off, is_owner, nb: int):
    """Distributed (Y, T) from local Q₁ rows + the replicated correction W
    and top-block modified LU (square_hr.hr_panel_fused over sharded rows):
    Y = Q·U⁻¹ = Q₁·(W·U⁻¹) — one local tall pass with the nb³ factors
    folded first; the owner's top block is then overwritten with the LU's
    exact L1. The two triangular inverses run as one B=2 doubling batch."""
    dt = q1.dtype
    eye = jnp.eye(nb, dtype=dt)
    l1 = jnp.tril(lu, -1) + eye
    u = jnp.triu(lu)
    invs = _triu_inv_doubling(jnp.stack([u, jnp.transpose(l1)]), _HI)
    uinv, l1tinv = invs[0], invs[1]
    t = -_dot(u * d[None, :], l1tinv, _HI, dt)
    y = _dot(q1, _dot(w, uinv, _HI, dt), _HI, dt)
    ysub = jax.lax.dynamic_slice(y, ix(top_off, 0), (nb, nb))
    y = jax.lax.dynamic_update_slice(
        y, jnp.where(is_owner > 0, l1, ysub), ix(top_off, 0)
    )
    return y, t


def _apply_panel_dist(y, t, c, prec, trans: bool):
    """C ← (I − Y·T·Yᵀ)ᵀ C (trans) / (I − Y·T·Yᵀ) C over sharded rows:
    one psum_rows of the nb-row projection, two local matmuls.

    The LOCAL projection W = YᵀC accumulates pairwise over row blocks, as
    the single-device hr update does (common.bdot_pair_rows); the psum
    across 'rows' above it is already a device-level tree."""
    dt = c.dtype
    w = jax.lax.psum(bdot_pair_rows(y, c, prec), "rows")
    tm = jnp.transpose(t) if trans else t
    w = _dot(tm, w, prec, dt)
    return c - _dot(y, w, prec, dt)


def _seg_table(k_max: int, pr: int, pc: int, segments: int):
    """Segment boundaries + per-segment static local row/col tile starts.

    Segment s covers panels [ks, ke). Its local slice must contain every
    row/col tile any device still needs at panel ks: global tile ≥ ks maps
    to local tile ≥ (ks − (p−1)) // p on the furthest-ahead device — the
    conservative start; the window mask absorbs the ≤1-tile raggedness."""
    segments = max(1, min(segments, k_max))
    bounds = [round(s * k_max / segments) for s in range(segments + 1)]
    segs = []
    for s in range(segments):
        ks, ke = bounds[s], bounds[s + 1]
        if ks == ke:
            continue
        lr = max(0, ks - (pr - 1)) // pr
        lc = max(0, ks - (pc - 1)) // pc
        segs.append((ks, ke, lr, lc))
    return tuple(segs)


def qr_sharded_factor_hr(
    a: jnp.ndarray,
    mesh: Optional[Mesh] = None,
    config: Optional[QRConfig] = None,
    segments: int = SEGMENTS,
) -> ShardedHRFactors:
    """Factor A across a 2D mesh with gram-reduced CholeskyQR2 panels +
    Householder reconstruction. One shard_map program whose size is
    O(segments), independent of panel count (``segments`` bounds the
    full-extent flop waste at ~1 + 3/(2·segments))."""
    cfg = config if config is not None else QRConfig()
    nb = cfg.nb
    if mesh is None:
        mesh = make_mesh(cfg)
    pr, pc = mesh.devices.shape
    a = jnp.asarray(a, cfg.dtype)
    m, n = a.shape
    mp, np_ = jax.eval_shape(
        lambda x: pad_for_hr(x, nb, row_mult=nb * pr, col_mult=nb * pc)[0], a
    ).shape
    mt, nt = mp // nb, np_ // nb
    segs = _seg_table(min(mt, nt), pr, pc, segments)
    local_out, r_diag, t_all, health, y_segs = _factor_hr_jit(
        a, nb, (mt, nt, pr, pc), segs, cfg.precision, mesh
    )
    # the guard is a host-side api concern (drivers/sharded.qr_sharded);
    # the scalar rides the factors either way — hr_guard="off" callers can
    # simply ignore it (an extra max chain per panel costs nothing against
    # the update matmuls, so no stats knob forks the executable here)
    return ShardedHRFactors(
        local_out, r_diag, t_all, y_segs, nb, (m, n), (mt, nt, pr, pc), segs,
        health,
    )


@functools.partial(
    jax.jit, static_argnames=("nb", "grid", "segs", "precision", "mesh")
)
def _factor_hr_jit(a, nb, grid, segs, precision, mesh):
    mt, nt, pr, pc = grid
    prec = resolve_precision(precision)
    k_max = min(mt, nt)
    ap, _ = pad_for_hr(a, nb, row_mult=nb * pr, col_mult=nb * pc)
    local = _to_local_layout(ap, nb, pr, pc)

    def body(loc_in):
        loc = loc_in[0, 0]
        r = jax.lax.axis_index("rows")
        col = jax.lax.axis_index("cols")
        dt = loc.dtype
        r_diag = jnp.zeros((k_max, nb, nb), dt)
        t_all = jnp.zeros((k_max, nb, nb), dt)
        health = jnp.zeros((), dt)
        y_outs = []

        for ks, ke, lr, lc in segs:
            sub = loc[lr * nb :, lc * nb :]
            lm_s = sub.shape[0]
            rowg = ((jnp.arange(lm_s) // nb) + lr) * pr + r
            y_seg = jnp.zeros((ke - ks, lm_s, nb), dt)

            def panel(k, carry, lr=lr, lc=lc, ks=ks, rowg=rowg, lm_s=lm_s):
                k = jnp.asarray(k, jnp.int32)
                sub, r_diag, y_seg, t_all, health = carry
                r_k, c_k = k % pr, k % pc
                is_owner = (r == r_k).astype(dt)
                top_off = (k // pr - lr) * nb

                pcol_own = jax.lax.dynamic_slice(
                    sub, ix(0, (k // pc - lc) * nb), (lm_s, nb)
                )
                pcol = jax.lax.psum(
                    pcol_own * (col == c_k).astype(dt), "cols"
                )
                wmask = (rowg >= k).astype(dt)[:, None]
                p = pcol * wmask

                q1, wc, rch, emax = _cholqr2_psum(p, nb)
                health = jnp.maximum(health, emax)
                q1top = jax.lax.dynamic_slice(q1, ix(top_off, 0), (nb, nb))
                q1top = jax.lax.psum(q1top * is_owner, "rows")
                # Q_top = Q₁_top·W — replicated nb³; Q itself is never formed
                qtop = _dot(q1top, wc, _HI, dt)
                lu, d = modified_lu(qtop)
                y, t = _reconstruct_yt_dist(q1, wc, lu, d, top_off, is_owner, nb)
                y = y * wmask

                sub = _apply_panel_dist(y, t, sub, prec, trans=True)

                r_diag = jax.lax.dynamic_update_slice(
                    r_diag, (d[:, None] * rch)[None], ix(k, 0, 0)
                )
                y_seg = jax.lax.dynamic_update_slice(
                    y_seg, y[None], ix(k - ks, 0, 0)
                )
                t_all = jax.lax.dynamic_update_slice(
                    t_all, t[None], ix(k, 0, 0)
                )
                return sub, r_diag, y_seg, t_all, health

            sub, r_diag, y_seg, t_all, health = jax.lax.fori_loop(
                ks, ke, panel, (sub, r_diag, y_seg, t_all, health)
            )
            low = (
                jnp.concatenate([loc[lr * nb :, : lc * nb], sub], axis=1)
                if lc
                else sub
            )
            loc = jnp.concatenate([loc[: lr * nb, :], low], axis=0) if lr else low
            y_outs.append(y_seg[None])

        return (loc[None, None], r_diag, t_all, health, tuple(y_outs))

    sh = P("rows", "cols")
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(sh,),
        out_specs=(sh, P(), P(), P(), tuple(P("rows") for _ in segs)),
        check_vma=False,
    )(local)


def assemble_r_sharded_hr(f: ShardedHRFactors, mesh: Optional[Mesh] = None):
    """R (M, N) as a device array computed under jit (triu of the updated
    local matrices + the replicated diagonal tiles)."""
    from tileqr.drivers.sharded import assemble_r_sharded

    return assemble_r_sharded(f, mesh)


def apply_q_sharded_hr(
    f: ShardedHRFactors,
    c_mat: jnp.ndarray,
    mesh: Optional[Mesh] = None,
    trans: bool = True,
    config: Optional[QRConfig] = None,
):
    """C ← Qᵀ C (trans) or Q C from the distributed whole-panel factors;
    returns a device array (Mc, P). One psum_rows + two local matmuls per
    panel — the factor phase's update step replayed, segment-sliced like
    the factor (Qᵀ runs segments forward, Q reversed)."""
    cfg = config if config is not None else QRConfig(nb=f.nb)
    mt, nt, pr, pc = f.grid
    if mesh is None:
        mesh = mesh_from_factors(f.local, pr, pc)
    c_mat = jnp.asarray(c_mat, f.local.dtype)
    out = _apply_hr_jit(
        c_mat, f.t_all, f.y_segs, f.nb, f.grid, f.segs, trans, cfg.precision, mesh
    )
    return out[: c_mat.shape[0], : c_mat.shape[1]]


@functools.partial(
    jax.jit,
    static_argnames=("nb", "grid", "segs", "trans", "precision", "mesh"),
)
def _apply_hr_jit(c_mat, t_all, y_segs, nb, grid, segs, trans, precision, mesh):
    mt, nt, pr, pc = grid
    prec = resolve_precision(precision)
    lmt = mt // pr
    mc, p = c_mat.shape
    ppad = round_up(max(p, 1), nb * pc)
    cp = jnp.pad(c_mat, ((0, mt * nb - mc), (0, ppad - p)))
    cl = _to_local_layout(cp, nb, pr, pc)
    lpt = cl.shape[3] // nb

    seg_order = range(len(segs)) if trans else reversed(range(len(segs)))
    seg_order = list(seg_order)

    def body(cloc, t_all, *y_segs):
        cm = cloc[0, 0]

        for si in seg_order:
            ks, ke, lr, _lc = segs[si]
            y_seg = y_segs[si][0]
            sub = cm[lr * nb :, :]

            def one_panel(i, sub, ks=ks, ke=ke, y_seg=y_seg):
                i = jnp.asarray(i, jnp.int32)
                k = ks + i if trans else (ke - 1 - i)
                y = jax.lax.dynamic_slice(
                    y_seg, ix(k - ks, 0, 0), (1,) + y_seg.shape[1:]
                )[0]
                t = jax.lax.dynamic_slice(t_all, ix(k, 0, 0), (1, nb, nb))[0]
                return _apply_panel_dist(y, t, sub, prec, trans=trans)

            sub = jax.lax.fori_loop(0, ke - ks, one_panel, sub)
            cm = jnp.concatenate([cm[: lr * nb, :], sub], axis=0) if lr else sub

        return cm[None, None]

    sh = P("rows", "cols")
    cl_out = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(sh, P()) + tuple(P("rows") for _ in segs),
        out_specs=sh,
        check_vma=False,
    )(cl, t_all, *y_segs)
    return _unpack_local_jit(cl_out, nb, lmt, lpt, mesh)
