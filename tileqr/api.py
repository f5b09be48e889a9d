"""Public API (SURVEY.md §7.0 api.py; §3.4 build-side entry points).

Entries: qr / qr_factor (square-blocked path), tsqr (tall-skinny tree path),
qr_batched (vmapped tile path), orgqr / apply_q (Q formation/application —
the reference's "Add" list, BASELINE.json:5), lstsq (QR-based least squares),
qr_sharded (re-exported from drivers.sharded).

All entries accept arbitrary (M, N); inputs are zero-padded to tile
multiples (padding is exact for QR: padded rows/columns yield tau = 0
reflectors and zero R blocks) and results are sliced back.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from tileqr.core.config import QRConfig
from tileqr.core.layout import pad_to_tiles, round_up
from tileqr.drivers.batched import qr_batched as _qr_batched
from tileqr.drivers import square
from tileqr.drivers.square import (
    PanelStack,
    apply_q_loop,
    apply_q_tiled,
    assemble_r,
    qr_tiled,
    qr_tiled_loop,
)
from tileqr.drivers import square_hr
from tileqr.drivers.square_hr import (
    apply_q_hr,
    apply_q_hr_chunked,
    orgqr_hr,
    pad_for_hr,
    qr_hr,
    qr_hr_chunked,
)
from tileqr.drivers.tsqr import (
    TSQRFactors,
    auto_leaf_rows,
    tsqr_apply_q,
    tsqr_factor,
    tsqr_form_q,
)


class QRFactors(NamedTuple):
    """Packed tiled-QR factors: the factored matrix (off-diagonal R tiles
    in its upper triangle), the diagonal R tiles, the GEQRT T factors and
    the per-panel reflectors: a tuple per panel from ``qr_tiled`` (layout:
    drivers/square.py docstring), or a ``PanelStack`` from the loop driver
    (more than ``square.STATIC_MAX_PANELS`` panels at chunk=0)."""

    packed: jnp.ndarray
    r_diag: jnp.ndarray
    t_geqrt: jnp.ndarray
    panels: Tuple
    nb: int
    chunk: int
    shape: Tuple[int, int]  # original (M, N) before padding
    # QRConfig.prescale: A was factored as (A/scale) = Q·R_stored, so
    # R_true = scale · R_stored; Q and the packed reflectors are
    # scale-invariant. 1.0 (python float) when prescaling is off.
    scale: object = 1.0


# pytree with (nb, chunk, shape) static — factors cross jit boundaries as
# arguments without tracing their int fields (see drivers/tsqr.py rationale)
jax.tree_util.register_pytree_node(
    QRFactors,
    lambda f: ((f.packed, f.r_diag, f.t_geqrt, f.panels, f.scale),
               (f.nb, f.chunk, f.shape)),
    lambda aux, ch: QRFactors(ch[0], ch[1], ch[2], ch[3], *aux, ch[4]),
)


class HRFactors(NamedTuple):
    """Factors from the CholeskyQR2+reconstruction square path
    (QRConfig.square_method="hr", drivers/square_hr.py): per-panel whole-panel
    compact-WY pairs (Y_k, T_k) plus the assembled R (padded K × N_pad).

    ``health`` (device scalar, present unless QRConfig.hr_guard="off") is
    the max over panels of the CholeskyQR round-1 orthogonality defect
    ‖Q₁ᵀQ₁ − I‖_max — the hr conditioning monitor. Values ≲ 1e-3 are deep
    inside the hr contract; > QRConfig.hr_guard_tau (or NaN) means a panel
    broke the cond²·eps limit and the factors should not be trusted (the
    api-level guard warns/falls back on this; inside a jax.jit trace the
    scalar is carried here for the caller to gate on)."""

    r: jnp.ndarray
    panels: Tuple  # ((Y_0, T_0), (Y_1, T_1), ...), Y_k: (M_pad − k·nb, nb)
    nb: int
    shape: Tuple[int, int]  # original (M, N)
    scale: object = 1.0  # see QRFactors.scale
    health: object = None  # device scalar or None (hr_guard="off")


jax.tree_util.register_pytree_node(
    HRFactors,
    lambda f: ((f.r, f.panels, f.scale, f.health), (f.nb, f.shape)),
    lambda aux, ch: HRFactors(ch[0], ch[1], *aux, ch[2], ch[3]),
)


def _cfg(config: Optional[QRConfig]) -> QRConfig:
    return config if config is not None else QRConfig()


def _check_matrix(a, who: str) -> None:
    """Clear errors for the two input-shape classes every entry point
    would otherwise fail on with an obscure unpack/stack message: non-2-D
    inputs and zero-size dimensions (the tile padding has no meaningful
    factorization to pad toward)."""
    shape = jnp.shape(a)
    if len(shape) != 2:
        hint = (
            " — for a stack of matrices use tileqr.qr_batched"
            if len(shape) == 3
            else ""
        )
        raise ValueError(f"{who} expects a 2-D matrix, got shape {shape}{hint}")
    if shape[0] == 0 or shape[1] == 0:
        raise ValueError(f"{who}: zero-size dimension in input shape {shape}")


def _tracing_active() -> bool:
    """True when ANY jax trace is active — the predicate the tsqr auto
    routing needs (isinstance(a, Tracer) misses closure-captured concrete
    inputs under jit). Falls back to False (the pre-fix behavior) if the
    private helper ever moves."""
    try:
        from jax._src.core import trace_state_clean

        return not trace_state_clean()
    except Exception:
        return False


def _guard_trips(health, cfg: QRConfig, where: str) -> bool:
    """Host check of a CholeskyQR breakdown scalar — see
    drivers/cholqr.guard_trips (shared with the sharded-hr driver)."""
    from tileqr.drivers.cholqr import guard_trips

    return guard_trips(health, cfg, where)


def qr_factor(a: jnp.ndarray, config: Optional[QRConfig] = None) -> QRFactors:
    """Factor A → packed tiled Householder form (no Q/R assembly)."""
    _check_matrix(a, "qr_factor")
    cfg = _cfg(config)
    a = jnp.asarray(a, dtype=cfg.dtype)
    m, n = a.shape
    scale = 1.0
    if cfg.prescale:
        # exact power-of-2 scaling: QR(A/s) has identical reflectors/τ and
        # R_true = s · R_stored, with no rounding introduced by the division
        amax = jnp.max(jnp.abs(a))
        tiny = jnp.asarray(jnp.finfo(a.dtype).tiny, a.dtype)
        e = jnp.ceil(jnp.log2(jnp.maximum(amax, tiny)))
        # clamp per dtype: exp2(maxexp) overflows; amax/2^(maxexp-1) <= 2
        # never overflows the downstream column norms
        s = jnp.exp2(jnp.minimum(e, float(jnp.finfo(a.dtype).maxexp - 1)))
        scale = jnp.where(amax > 0, s, jnp.ones((), a.dtype))
        # true division, NOT multiply-by-reciprocal: 1/2^127 is subnormal
        # and XLA flushes it to zero (caught by test_prescale_near_fp32_max)
        a = a / scale
    if cfg.square_method == "hr":
        stats = cfg.hr_guard != "off"
        ap, _ = pad_for_hr(a, cfg.nb)
        # past STATIC_MAX_PANELS the panel loop runs as segmented
        # executables with a donated carry (bitwise-equal to qr_hr)
        drv = qr_hr_chunked if min(ap.shape) // cfg.nb > square.STATIC_MAX_PANELS else qr_hr
        out = drv(ap, cfg.nb, precision=cfg.precision, stats=stats)
        health = out[2] if stats else None
        f = HRFactors(out[0], out[1], cfg.nb, (m, n), scale, health)
        # hr breakdown guard (QRConfig.hr_guard). The host check needs a
        # concrete scalar: inside a jax.jit trace `health` is a tracer and
        # the check is skipped — HRFactors.health still carries the device
        # scalar for the caller to gate on (documented on HRFactors).
        if not _guard_trips(health, cfg, "qr_factor/hr") or cfg.hr_guard != "fallback":
            return f
        # fall through to the hh path below: `a` is already prescaled and
        # `scale` already captured, so the fallback reuses both
    ap, _ = pad_to_tiles(a, cfg.nb)
    if cfg.chunk == 0 and min(ap.shape) // cfg.nb > square.STATIC_MAX_PANELS:
        # one compiled panel body per segment instead of one per panel
        packed, r_diag, t_g, panels = qr_tiled_loop(ap, cfg.nb, precision=cfg.precision)
    else:
        packed, r_diag, t_g, panels = qr_tiled(
            ap, cfg.nb, chunk=cfg.chunk, precision=cfg.precision
        )
    return QRFactors(packed, r_diag, t_g, panels, cfg.nb, cfg.chunk, (m, n), scale)


def _check_rows(c, m: int):
    if c.ndim != 2:
        raise ValueError(f"c must be (M, P), got shape {c.shape}")
    if c.shape[0] != m:
        raise ValueError(f"c rows {c.shape[0]} != M {m}")


def apply_q(
    f, c: jnp.ndarray, trans: bool = False, config: Optional[QRConfig] = None
) -> jnp.ndarray:
    """C ← Q C (or Qᵀ C) for QRFactors, HRFactors or TSQRFactors.
    c: (M, P) in the ORIGINAL row dimension."""
    cfg = _cfg(config)
    if isinstance(f, TSQRFactors):
        c = jnp.asarray(c, dtype=f.r.dtype)
        _check_rows(c, f.shape[0])
        return tsqr_apply_q(f, c, trans=trans, precision=cfg.precision)
    if isinstance(f, HRFactors):
        mp = f.panels[0][0].shape[0]
        c = jnp.asarray(c, dtype=f.r.dtype)
        _check_rows(c, f.shape[0])
        cp = jnp.pad(c, ((0, mp - c.shape[0]), (0, 0)))
        if len(f.panels) > square.STATIC_MAX_PANELS:
            # segmented apply (the trace-unrolled one grows the compile the
            # same way the factor's does)
            out = apply_q_hr_chunked(
                f.panels, cp, f.nb, trans=trans, precision=cfg.precision
            )
        else:
            out = apply_q_hr(f.panels, cp, f.nb, trans=trans, precision=cfg.precision)
        return out[: c.shape[0]]
    mp = f.packed.shape[0]
    c = jnp.asarray(c, dtype=f.packed.dtype)
    _check_rows(c, f.shape[0])
    mc, p = c.shape
    cp = jnp.pad(c, ((0, mp - mc), (0, 0)))
    drv = apply_q_loop if isinstance(f.panels, PanelStack) else apply_q_tiled
    out = drv(f.panels, f.t_geqrt, cp, f.nb, trans=trans, precision=cfg.precision)
    return out[:mc, :p]


def orgqr(f, ncols: Optional[int] = None, config: Optional[QRConfig] = None):
    """Form Q explicitly: M×ncols (default: reduced, ncols = min(M, N)).

    LAPACK xORGQR equivalent on the tiled factors (SURVEY.md §3.4). On the
    hh path the apply uses the xORGQR growing-window trick
    (apply_q_tiled triangular=True): panel k is an exact no-op on the
    identity's column tiles < k, halving the Q-formation flops. Fewer
    columns than min(M, N) are sliced from the reduced Q, so Q's leading
    columns are bitwise the same whatever ncols asks for."""
    cfg = _cfg(config)
    m, n = f.shape
    k = min(m, n) if ncols is None else ncols
    kw = max(k, min(m, n))  # the width actually formed
    if isinstance(f, TSQRFactors):
        if k <= n:
            # leaf-local Q assembly — no M×M identity is materialized
            return tsqr_form_q(f, precision=cfg.precision)[:m, :k]
        return apply_q(f, jnp.eye(m, k, dtype=f.r.dtype), config=cfg)
    if isinstance(f, HRFactors):
        mp = f.panels[0][0].shape[0]
        if len(f.panels) > square.STATIC_MAX_PANELS:
            # segmented Q formation: a full apply to a padded identity
            # (~2× the growing-window flops, but O(k_max/8) small programs
            # instead of one trace-unrolled program)
            kp = round_up(kw, f.nb)
            eye_p = jnp.eye(mp, kp, dtype=f.r.dtype)
            out = apply_q_hr_chunked(
                f.panels, eye_p, f.nb, trans=False, precision=cfg.precision
            )
        else:
            out = orgqr_hr(f.panels, mp, f.nb, kw, precision=cfg.precision)
        return out[:m, :k]
    mp = f.packed.shape[0]
    eye_p = jnp.eye(mp, round_up(kw, f.nb), dtype=f.packed.dtype)
    if isinstance(f.panels, PanelStack):
        # a full apply to the identity (the growing window needs per-panel
        # shapes)
        out = apply_q_loop(
            f.panels, f.t_geqrt, eye_p, f.nb, trans=False, precision=cfg.precision
        )
        return out[:m, :k]
    out = apply_q_tiled(
        f.panels, f.t_geqrt, eye_p, f.nb, trans=False,
        precision=cfg.precision, triangular=True,
    )
    return out[:m, :k]


def qr(
    a: jnp.ndarray, mode: str = "reduced", config: Optional[QRConfig] = None
):
    """Tiled blocked QR. mode: "reduced" → (Q (M,K), R (K,N)); "complete" →
    (Q (M,M), R (M,N)); "r" → R (K,N) only. K = min(M, N)."""
    _check_matrix(a, "qr")
    cfg = _cfg(config)
    f = qr_factor(a, cfg)
    m, n = f.shape
    k = min(m, n)
    if isinstance(f, HRFactors):
        r_full = f.r * f.scale
        if r_full.shape[0] < m:  # complete mode on tall input needs M rows
            r_full = jnp.pad(r_full, ((0, m - r_full.shape[0]), (0, 0)))
    else:
        r_full = assemble_r(f.packed, f.r_diag, f.nb) * f.scale
    if mode == "r":
        return r_full[:k, :n]
    if mode == "reduced":
        q = orgqr(f, k, cfg)
        return q, r_full[:k, :n]
    if mode == "complete":
        q = orgqr(f, m, cfg)
        return q, r_full[:m, :n]
    raise ValueError(f"unknown mode {mode!r}")


def tsqr(
    a: jnp.ndarray,
    mode: str = "r",
    config: Optional[QRConfig] = None,
    strategy: str = "auto",
):
    """Communication-avoiding tall-skinny QR.

    a: (M, n) with n <= nb. mode "r" → R (n, n); "reduced" → (Q (M, n), R);
    "factor" → TSQRFactors (for apply_q / orgqr).

    strategy:
      "tree": the TSQR/TTQRT tree reduction (reference path C8): one
        batched Householder call over the leaves, then wide-arity combines
        (drivers/tsqr.py).
      "chain": route through the square driver (one wide panel).
      "cholqr2": CholeskyQR2 (drivers/cholqr.py, B=1): R via ONE gram
        reduction + Cholesky + matmul-only correction — no Householder
        columns at all, and the gram is the maximally communication-
        avoiding cross-device reduction (a single psum). Requires
        cond(A) ≲ 1e3 in fp32. mode="factor" returns whole-panel compact-WY
        HRFactors via modified-LU Householder reconstruction
        (square_hr.hr_panel with nb = panel width) — apply with
        tileqr.apply_q / form Q with tileqr.orgqr.
      "auto": "chain" for modes "r" and "reduced" (one wide panel through
        cuSOLVER geqrf; on one device it beats the tree, PERF.md); "factor"
        routes to the cholqr2 reconstruction with the breakdown guard
        falling back to tree TSQRFactors (warning) under the default
        hr_guard="fallback".
    """
    _check_matrix(a, "tsqr")
    cfg = _cfg(config)
    if strategy not in ("auto", "tree", "chain", "cholqr2"):
        raise ValueError(f"unknown strategy {strategy!r} (auto/tree/chain/cholqr2)")
    if strategy == "auto" and mode == "factor":
        # The fast route is taken ONLY when the guard's fallback can act:
        # with hr_guard "off"/"warn", or under a jax.jit trace (tracer
        # health — guard_trips cannot host-sync and returns False), "auto"
        # keeps the unconditionally stable tree. Callers who want cholqr2
        # without the guard opt in by naming strategy="cholqr2". The trace
        # test must look at the TRACE STATE, not just the input: a concrete
        # array captured by closure under jit is not a Tracer, but the
        # health scalar the guard reads would still emerge as one.
        guard_can_act = (
            cfg.hr_guard == "fallback"
            and not isinstance(a, jax.core.Tracer)
            and not _tracing_active()
        )
        return tsqr(
            a, mode="factor", config=cfg,
            strategy="cholqr2" if guard_can_act else "tree",
        )
    if strategy == "auto":
        strategy = "chain"
    if strategy == "cholqr2":
        from tileqr.drivers.cholqr import cholqr2_batched

        a = jnp.asarray(a, dtype=cfg.dtype)
        m, n = a.shape
        stats = cfg.hr_guard != "off"
        if mode == "factor":
            # whole-panel compact-WY factors at CholeskyQR2 speed:
            # CholeskyQR2 → modified-LU Householder reconstruction — exactly
            # square_hr.hr_panel with nb = the panel width. Returns
            # HRFactors with ONE panel; apply_q / orgqr consume it through
            # their hr route (the tree's TSQRFactors stay the
            # unconditionally stable factor path).
            from tileqr.drivers.square_hr import hr_panel

            if m < n:
                raise ValueError("tsqr requires M >= n")
            nbp = round_up(max(n, 8), 8)
            ap, _ = pad_for_hr(a, nbp)
            out = hr_panel(ap, stats=stats)
            y, t, rk = out[0], out[1], out[2]
            health = out[3] if stats else None
            bad = _guard_trips(health, cfg, "tsqr(factor, strategy='cholqr2')")
            if bad and cfg.hr_guard == "fallback":
                return tsqr(a, mode="factor", config=cfg, strategy="tree")
            return HRFactors(rk, ((y, t),), nbp, (m, n), 1.0, health)
        if mode not in ("r", "reduced"):
            raise ValueError(f"unknown mode {mode!r}")
        out = cholqr2_batched(
            a[None], mode=mode, precision=cfg.precision, stats=stats
        )
        health = out[-1] if stats else None
        if mode == "r":
            res = out[0][0] if stats else out[0]
        else:
            res = (out[0][0], out[1][0])
        bad = _guard_trips(health, cfg, "tsqr(strategy='cholqr2')")
        if bad and cfg.hr_guard == "fallback":
            # the tree is unconditionally stable
            return tsqr(a, mode=mode, config=cfg, strategy="tree")
        return res
    if strategy == "chain" and mode == "factor":
        # the chain path has no TSQRFactors representation — silently
        # returning tree factors would hand the caller a different object
        # than the strategy they named
        raise ValueError(
            'tsqr(strategy="chain") has no "factor" mode; use strategy='
            '"tree" (TSQRFactors) or qr_factor (square factors)'
        )
    if strategy == "chain":
        if a.shape[1] > cfg.nb:
            raise ValueError(f"tsqr requires n={a.shape[1]} <= nb={cfg.nb}")
        return qr(a, mode=mode, config=cfg)
    a = jnp.asarray(a, dtype=cfg.dtype)
    m, n = a.shape
    nb = cfg.nb
    if n > nb:
        raise ValueError(f"tsqr requires n={n} <= nb={nb}")
    np_ = round_up(n, 8)
    lr = auto_leaf_rows(round_up(m, 8), np_)
    mp = round_up(m, lr)
    ap = jnp.pad(a, ((0, mp - m), (0, np_ - n)))
    f = tsqr_factor(ap, nb, leaf_rows=lr, shape=(m, n))
    r = f.r[:n, :n]
    if mode == "r":
        return r
    if mode == "factor":
        return f
    if mode == "reduced":
        # leaf-local Q assembly — no M×n identity is materialized
        q = tsqr_form_q(f, precision=cfg.precision)
        return q[:m, :n], r
    raise ValueError(f"unknown mode {mode!r}")


def qr_batched(
    a: jnp.ndarray, mode: str = "reduced", config: Optional[QRConfig] = None
):
    """Batched QR of (B, m, n) stacks of small matrices (single-tile path,
    BASELINE.json:10)."""
    shape = jnp.shape(a)
    if len(shape) != 3 or 0 in shape:
        raise ValueError(
            f"qr_batched expects a (B, m, n) stack with no zero-size "
            f"dimension, got shape {shape}"
        )
    cfg = _cfg(config)
    a = jnp.asarray(a, dtype=cfg.dtype)
    b, m, n = a.shape
    mp, np_ = round_up(m, 8), round_up(n, 8)
    ap = jnp.pad(a, ((0, 0), (0, mp - m), (0, np_ - n)))
    if cfg.batched_method == "cholqr2":
        # column padding would make the gram singular — pad rows only
        from tileqr.drivers.cholqr import cholqr2_batched

        if m < n:
            raise ValueError("cholqr2 requires m >= n")
        stats = cfg.hr_guard != "off"
        apc = jnp.pad(a, ((0, 0), (0, mp - m), (0, 0)))
        out = cholqr2_batched(
            apc, mode=mode, precision=cfg.precision, stats=stats
        )
        health = out[-1] if stats else None
        # one bad member trips the whole batch to the Householder path —
        # square gaussian 128² batches contain ill-conditioned tails whose
        # CholeskyQR breaks down
        bad = _guard_trips(health, cfg, "qr_batched/cholqr2")
        if not (bad and cfg.hr_guard == "fallback"):
            if mode == "r":
                return out[0] if stats else out
            q, r = out[0], out[1]
            return q[:, :m, :], r
        # fall through to the hh batched path below (cfg routing bypassed)
    elif cfg.batched_method != "hh":
        raise ValueError(f"unknown batched_method {cfg.batched_method!r}")
    out = _qr_batched(ap, mode=mode, precision=cfg.precision)
    if mode == "r":
        return out[:, :n, :n]
    q, r = out
    return q[:, :m, :n], r[:, :n, :n]


def lstsq(a: jnp.ndarray, b: jnp.ndarray, config: Optional[QRConfig] = None):
    """Least-squares solve min ‖Ax − b‖₂ via QR (M >= N, full rank).

    b: (M,) or (M, P). Returns x: (N,) or (N, P). (SURVEY.md §3.4: apply Qᵀ
    to b through the tiled reflectors, then back-solve on R.)"""
    _check_matrix(a, "lstsq")
    cfg = _cfg(config)
    b_in = jnp.asarray(b, dtype=cfg.dtype)
    if b_in.ndim not in (1, 2):
        raise ValueError(f"lstsq: b must be (M,) or (M, P), got shape {b_in.shape}")
    vec = b_in.ndim == 1
    bmat = b_in[:, None] if vec else b_in
    m, n = a.shape
    if m < n:
        raise ValueError("lstsq requires M >= N")
    f = qr_factor(a, cfg)
    qtb = apply_q(f, bmat, trans=True, config=cfg)[:n]
    if isinstance(f, HRFactors):
        r = f.r[:n, :n] * f.scale
    else:
        r = assemble_r(f.packed, f.r_diag, f.nb)[:n, :n] * f.scale
    x = jax.scipy.linalg.solve_triangular(r, qtb, lower=False)
    return x[:, 0] if vec else x
