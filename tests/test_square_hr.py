"""CholeskyQR2 + Householder-reconstruction square path
(QRConfig.square_method="hr", drivers/square_hr.py, kernels/modlu.py).

Same public-API surface as the default Householder path, with the hr
conditioning contract (cond(A) ≲ 1e3 in fp32): every entry point is
exercised through tileqr.* with arbitrary (unpadded) shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tileqr
from tileqr import QRConfig
from tileqr.drivers import square
from tileqr.drivers.square_hr import hr_panel, pad_for_hr, qr_hr
from tileqr.kernels.modlu import modified_lu

CFG = QRConfig(nb=32, square_method="hr")


def relerr(a, b):
    a64, b64 = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a64 - b64) / np.linalg.norm(b64)


def test_modified_lu_identity(rng):
    """LU resid + pivot bound: Q_top − diag(d) = L1·U with |L| ≤ 1 and
    U's pivots ≥ 1 (the sign modification d_j = −sign(q_jj) guarantees
    pivot = |q_jj| + 1 after the preceding eliminations — Ballard et al.)."""
    q_np, _ = np.linalg.qr(rng.standard_normal((128, 32)))
    q = jnp.asarray(q_np, jnp.float32)
    lu, d = modified_lu(q[:32])
    lu64 = np.asarray(lu, np.float64)
    l1 = np.tril(lu64, -1) + np.eye(32)
    u = np.triu(lu64)
    assert np.linalg.norm(l1 @ u - (np.asarray(q[:32], np.float64) - np.diag(np.asarray(d, np.float64)))) < 1e-5
    assert np.abs(np.diag(u)).min() >= 0.9  # pivots bounded away from 0
    assert np.abs(l1).max() <= 1.0 + 1e-6
    assert set(np.unique(np.asarray(d))) <= {-1.0, 1.0}


@pytest.mark.parametrize("n", [8, 64, 128, 256])
def test_modified_lu_widths(rng, n):
    """The plain modified LU at panel widths up to the acceptance nb:
    L·U = Q1 − diag(d) and every pivot |u_jj| ≥ 1 (the on-the-fly sign
    choice bounds them to [1, 2])."""
    q_np, _ = np.linalg.qr(rng.standard_normal((2 * n, n)))
    q = jnp.asarray(q_np[:n], jnp.float32)
    lu, d = modified_lu(q)
    lu64 = np.asarray(lu, np.float64)
    l1 = np.tril(lu64, -1) + np.eye(n)
    u = np.triu(lu64)
    resid = l1 @ u - (np.asarray(q, np.float64) - np.diag(np.asarray(d, np.float64)))
    assert np.abs(resid).max() < 1e-5
    assert np.abs(np.diag(u)).min() >= 1.0 - 1e-6
    assert set(np.unique(np.asarray(d))) <= {-1.0, 1.0}


def test_hr_panel_compact_wy(rng):
    """One panel: (Y, T) reconstructed from CholeskyQR2's Q satisfies the
    GEQRT contract — Y unit lower trapezoidal, T upper triangular,
    (I − Y T Yᵀ)[:, :nb] · R = panel."""
    p = jnp.asarray(rng.standard_normal((128, 32)), jnp.float32)
    y, t, r = hr_panel(p)
    y64, t64 = np.asarray(y, np.float64), np.asarray(t, np.float64)
    assert np.allclose(np.diag(y64[:32]), 1.0, atol=1e-5)
    assert np.abs(np.triu(y64[:32], 1)).max() < 1e-6
    assert np.abs(np.tril(t64, -1)).max() < 1e-6
    qq = np.eye(128) - y64 @ t64 @ y64.T
    assert np.linalg.norm(qq.T @ qq - np.eye(128)) < 1e-5
    assert relerr(qq[:, :32] @ np.asarray(r, np.float64), p) < 3e-6


@pytest.mark.parametrize("m,n", [(128, 128), (160, 96), (96, 128), (100, 70), (130, 130)])
def test_qr_hr_reduced(rng, m, n):
    a = rng.standard_normal((m, n)).astype(np.float32)
    q, r = tileqr.qr(a, config=CFG)
    k = min(m, n)
    assert q.shape == (m, k) and r.shape == (k, n)
    q64, r64 = np.asarray(q, np.float64), np.asarray(r, np.float64)
    assert np.linalg.norm(a - q64 @ r64) / np.linalg.norm(a) < 3e-6
    assert np.linalg.norm(q64.T @ q64 - np.eye(k)) < 1e-4
    assert np.abs(r64[np.tril_indices(k, -1)]).max() < 1e-5 * np.abs(r64).max()


def test_qr_hr_complete_tall(rng):
    m, n = 160, 96
    a = rng.standard_normal((m, n)).astype(np.float32)
    q, r = tileqr.qr(a, mode="complete", config=CFG)
    assert q.shape == (m, m) and r.shape == (m, n)
    q64 = np.asarray(q, np.float64)
    assert relerr(q64 @ np.asarray(r, np.float64), a) < 3e-6
    assert np.linalg.norm(q64.T @ q64 - np.eye(m)) < 1e-4
    assert np.abs(np.asarray(r, np.float64)[n:]).max() == 0.0


def test_hr_orgqr_reduced_ncols(rng):
    """ncols < nb exercises the empty-trailing-panel skip; 40 the partial
    tile. Leading columns match the full Q to fp32 ulps."""
    a = rng.standard_normal((128, 128)).astype(np.float32)
    f = tileqr.qr_factor(a, CFG)
    q_full = np.asarray(tileqr.orgqr(f, config=CFG))
    for ncols in (8, 40):
        q_k = np.asarray(tileqr.orgqr(f, ncols=ncols, config=CFG))
        assert q_k.shape == (128, ncols)
        assert np.abs(q_k - q_full[:, :ncols]).max() < 1e-6


def test_hr_apply_q_roundtrip(rng):
    """Qᵀ(Q c) = c to fp32 accuracy — the apply path in both directions."""
    m = 160
    a = rng.standard_normal((m, 96)).astype(np.float32)
    f = tileqr.qr_factor(a, CFG)
    c = rng.standard_normal((m, 8)).astype(np.float32)
    qc = tileqr.apply_q(f, c, config=CFG)
    back = tileqr.apply_q(f, qc, trans=True, config=CFG)
    assert relerr(back, c) < 5e-6


def test_hr_lstsq(rng):
    m, n = 200, 64
    a = rng.standard_normal((m, n)).astype(np.float32)
    b = rng.standard_normal((m, 3)).astype(np.float32)
    x = np.asarray(tileqr.lstsq(a, b, config=CFG), np.float64)
    x_np, *_ = np.linalg.lstsq(a.astype(np.float64), b.astype(np.float64), rcond=None)
    assert np.linalg.norm(x - x_np) / np.linalg.norm(x_np) < 1e-4


def test_hr_matches_hh_r(rng):
    """R from the hr path = R from the default Householder path up to
    column signs and fp32 rounding (both factor the same A)."""
    a = rng.standard_normal((128, 128)).astype(np.float32)
    r_hr = np.asarray(tileqr.qr(a, mode="r", config=CFG), np.float64)
    r_hh = np.asarray(tileqr.qr(a, mode="r", config=QRConfig(nb=32)), np.float64)
    s = np.sign(np.diag(r_hr)) * np.sign(np.diag(r_hh))
    assert np.linalg.norm(r_hr * s[:, None] - r_hh) / np.linalg.norm(r_hh) < 1e-4


def test_hr_moderate_conditioning(rng):
    """cond(A) ≈ 300 — inside the documented cond ≲ 1e3 contract; the
    gram-squared conditioning must still deliver the 1e-6-class residual."""
    m = n = 128
    u, _ = np.linalg.qr(rng.standard_normal((m, m)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    sv = np.logspace(0, -2.5, min(m, n))
    a = (u[:, :n] * sv) @ v.astype(np.float64)
    a = a.astype(np.float32)
    q, r = tileqr.qr(a, config=CFG)
    assert relerr(np.asarray(q, np.float64) @ np.asarray(r, np.float64), a) < 5e-6
    q64 = np.asarray(q, np.float64)
    assert np.linalg.norm(q64.T @ q64 - np.eye(n)) < 1e-3


def test_hr_deterministic(rng):
    """Two runs → bitwise-identical factors (fixed reduction order in the
    gram/POTRF/reconstruction pipeline — the determinism contract)."""
    a = rng.standard_normal((128, 96)).astype(np.float32)
    q1, r1 = tileqr.qr(a, config=CFG)
    q2, r2 = tileqr.qr(a, config=CFG)
    assert (np.asarray(q1) == np.asarray(q2)).all()
    assert (np.asarray(r1) == np.asarray(r2)).all()


def test_hr_pad_for_hr_identity_block(rng):
    """Column padding carries the α-identity block: padded columns factor
    to exact unit reflectors and R's real block is untouched."""
    a = rng.standard_normal((96, 80)).astype(np.float32)  # 80 → pads to 96
    ap, (m, n) = pad_for_hr(jnp.asarray(a), 32)
    assert ap.shape[0] % 32 == 0 and ap.shape[1] % 32 == 0
    assert np.allclose(np.asarray(ap)[:m, :n], a)
    r, panels = qr_hr(ap, 32)
    # real block of R matches the unpadded factorization
    r_ref = np.linalg.qr(a.astype(np.float64))[1]
    r64 = np.asarray(r, np.float64)[:n, :n]
    s = np.sign(np.diag(r_ref)) * np.sign(np.diag(r64))
    assert np.linalg.norm(r64 * s[:, None] - r_ref) / np.linalg.norm(r_ref) < 2e-5


def test_hr_config_validation():
    with pytest.raises(ValueError):
        QRConfig(square_method="nope")


def test_hr_chunked_bitwise_matches_static(rng):
    """The bounded-compile segmented driver (qr_hr_chunked) is the SAME
    algorithm cut at jit boundaries: R and every (Y, T) panel must be
    bitwise-equal to the trace-unrolled qr_hr."""
    from tileqr.drivers.square_hr import qr_hr_chunked

    a = rng.standard_normal((192, 160)).astype(np.float32)
    ap1, _ = pad_for_hr(jnp.asarray(a), 32)
    r1, p1 = qr_hr(ap1, 32)
    ap2, _ = pad_for_hr(jnp.asarray(a), 32)  # fresh buffer: chunked donates
    r2, p2 = qr_hr_chunked(ap2, 32, seg_panels=2)
    assert (np.asarray(r1) == np.asarray(r2)).all()
    assert len(p1) == len(p2)
    for (y1, t1), (y2, t2) in zip(p1, p2):
        assert (np.asarray(y1) == np.asarray(y2)).all()
        assert (np.asarray(t1) == np.asarray(t2)).all()


def test_hr_chunked_panel_anchor_still_runs(rng):
    """The r_anchor="panel" A/B knob works through the segmented driver
    (the only hr route past square.STATIC_MAX_PANELS) and stays
    bitwise-equal to qr_hr."""
    from tileqr.drivers.square_hr import qr_hr_chunked

    a = rng.standard_normal((128, 96)).astype(np.float32)
    ap1, _ = pad_for_hr(jnp.asarray(a), 32)
    r1, p1 = qr_hr(ap1, 32, r_anchor="panel")
    ap2, _ = pad_for_hr(jnp.asarray(a), 32)
    r2, p2 = qr_hr_chunked(ap2, 32, seg_panels=2, r_anchor="panel")
    assert (np.asarray(r1) == np.asarray(r2)).all()
    for (y1, t1), (y2, t2) in zip(p1, p2):
        assert (np.asarray(y1) == np.asarray(y2)).all()
        assert (np.asarray(t1) == np.asarray(t2)).all()


def test_hr_api_routes_large_panel_counts_to_chunked(rng, monkeypatch):
    """qr_factor(square_method="hr") at a panel count past the auto-static
    ceiling must use the segmented driver (bounded compile, donated
    carry)."""
    import tileqr.api as api

    called = {}
    orig = api.qr_hr_chunked

    def spy(*args, **kw):
        called["yes"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(api, "qr_hr_chunked", spy)
    a = rng.standard_normal((40, 40)).astype(np.float32)
    cfg = QRConfig(nb=8, square_method="hr")  # 5 panels > ceiling below
    monkeypatch.setattr(square, "STATIC_MAX_PANELS", 4)
    q, r = tileqr.qr(a, config=cfg)
    assert called.get("yes")
    assert relerr(np.asarray(q, np.float64) @ np.asarray(r, np.float64), a) < 1e-5


def test_hr_apply_q_chunked_matches_unrolled(rng):
    """apply_q_hr_chunked is the unrolled apply cut at jit boundaries —
    bitwise-equal values, both directions."""
    from tileqr.drivers.square_hr import apply_q_hr_chunked

    a = rng.standard_normal((160, 128)).astype(np.float32)
    ap, _ = pad_for_hr(jnp.asarray(a), 32)
    r, panels = qr_hr(ap, 32)
    c_np = rng.standard_normal((160, 64)).astype(np.float32)
    for trans in (True, False):
        ref = np.asarray(
            tileqr.api.apply_q_hr(
                panels, jnp.asarray(c_np), 32, trans=trans
            )
        )
        # fresh target per call: the chunked apply DONATES it
        out = np.asarray(
            apply_q_hr_chunked(panels, jnp.asarray(c_np), 32, trans=trans, seg_panels=2)
        )
        assert (ref == out).all()


def test_hr_api_routes_large_panel_counts_to_chunked_apply(rng, monkeypatch):
    """apply_q/orgqr on HRFactors past the static panel ceiling must take
    the segmented apply; results stay correct."""
    import tileqr.api as api

    called = {}
    orig = api.apply_q_hr_chunked

    def spy(*a, **k):
        called["yes"] = True
        return orig(*a, **k)

    monkeypatch.setattr(api, "apply_q_hr_chunked", spy)
    monkeypatch.setattr(square, "STATIC_MAX_PANELS", 2)
    a = rng.standard_normal((128, 96)).astype(np.float32)
    cfg = QRConfig(nb=32, square_method="hr")
    q, r = tileqr.qr(a, config=cfg)  # 3 panels > 2 → chunked orgqr
    assert called.get("yes")
    assert relerr(np.asarray(q, np.float64) @ np.asarray(r, np.float64), a) < 1e-5
    q64 = np.asarray(q, np.float64)
    assert np.linalg.norm(q64.T @ q64 - np.eye(96)) < 1e-4


def test_apply_block_narrow_pairwise_accuracy(rng):
    """Narrow tall targets route W = YᵀC through the pairwise contraction
    (drivers/square_hr._apply_block_t): the apply must stay correct vs a
    float64 reference through that branch (m ≥ 2048 triggers it)."""
    from tileqr.drivers.square_hr import _apply_block_t, hr_panel

    m, nb = 2048, 32
    p = jnp.asarray(rng.standard_normal((m, nb)).astype(np.float32))
    y, t, _ = hr_panel(p)
    c = jnp.asarray(rng.standard_normal((m, 8)).astype(np.float32))
    out = np.asarray(
        _apply_block_t(y, t, c, jax.lax.Precision.HIGHEST, jnp.float32,
                       trans=True),
        np.float64,
    )
    y64, t64 = np.asarray(y, np.float64), np.asarray(t, np.float64)
    ref = np.asarray(c, np.float64) - y64 @ (t64.T @ (y64.T @ np.asarray(c, np.float64)))
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-6


def test_apply_block_wide_splitk_accuracy(rng):
    """Wide targets on tall panels (m ≥ 4096): W = YᵀC accumulates pairwise
    over row blocks in _apply_block_t, the step that keeps the accumulation
    error of wide updates down. The apply must stay correct vs a float64
    reference through it."""
    from tileqr.drivers.square_hr import _apply_block_t

    m, nb, q = 4096, 32, 1056
    # synthetic compact-WY-shaped factors (unit-lower-trapezoid Y, upper-
    # triangular T, reflector-like scaling): the branch under test is pure
    # linear algebra on these shapes — real hr_panel factors flow through
    # the same branch in test_qr_hr_* and the sharded twins
    y_np = rng.standard_normal((m, nb)).astype(np.float32) / np.sqrt(m)
    y_np[:nb] = np.tril(y_np[:nb], -1) + np.eye(nb, dtype=np.float32)
    t_np = np.triu(rng.standard_normal((nb, nb)).astype(np.float32)) / nb
    y, t = jnp.asarray(y_np), jnp.asarray(t_np)
    c = jnp.asarray(rng.standard_normal((m, q)).astype(np.float32))
    out = np.asarray(
        _apply_block_t(y, t, c, jax.lax.Precision.HIGHEST, jnp.float32,
                       trans=True),
        np.float64,
    )
    y64, t64 = np.asarray(y, np.float64), np.asarray(t, np.float64)
    ref = np.asarray(c, np.float64) - y64 @ (t64.T @ (y64.T @ np.asarray(c, np.float64)))
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-6


def test_hr_stats_bitwise_and_healthy(rng):
    """stats=True is a pure observer: (r, panels) bitwise-unchanged on both
    drivers, and gaussian inputs report a health (round-1 orthogonality
    defect) orders of magnitude inside the hr_guard_tau gate."""
    from tileqr.drivers.square_hr import qr_hr_chunked

    a = rng.standard_normal((160, 128)).astype(np.float32)
    ap, _ = pad_for_hr(jnp.asarray(a), 32)
    r0, p0 = qr_hr(ap, 32)
    r1, p1, h = qr_hr(ap, 32, stats=True)
    assert (np.asarray(r0) == np.asarray(r1)).all()
    for (y0, t0), (y1, t1) in zip(p0, p1):
        assert (np.asarray(y0) == np.asarray(y1)).all()
        assert (np.asarray(t0) == np.asarray(t1)).all()
    assert float(h) < 1e-3  # measured ~4e-7; tau default is 5e-2
    r2, _, h2 = qr_hr_chunked(
        jnp.asarray(np.asarray(ap)), 32, stats=True,
        seg_panels=2,
    )
    assert (np.asarray(r0) == np.asarray(r2)).all()
    assert float(h2) == float(h)  # same panel math, same defect


def _near_singular(rng, m=160, n=128):
    """A panel-0 breakdown input: a near-duplicate column pair makes the
    panel gram numerically singular (cond² ≈ 1e14 ≫ 1/eps32)."""
    b = rng.standard_normal((m, n)).astype(np.float32)
    b[:, 1] = b[:, 0] * (1 + 1e-7)
    return b


def test_hr_guard_fallback(rng):
    """Default hr_guard='fallback': breakdown input warns and refactors via
    the unconditionally stable Householder path — the result is
    acceptance-grade where raw hr would be garbage."""
    b = _near_singular(rng, m=96, n=64)  # panel-0 breakdown at 2 panels
    with pytest.warns(UserWarning, match="hr guard"):
        f = tileqr.qr_factor(b, QRConfig(nb=32, square_method="hr"))
    assert type(f).__name__ == "QRFactors"  # hh factors, not HRFactors
    with pytest.warns(UserWarning, match="hr guard"):
        q, r = tileqr.qr(b, config=QRConfig(nb=32, square_method="hr"))
    assert relerr(np.asarray(q, np.float64) @ np.asarray(r, np.float64), b) < 1e-6


def test_hr_guard_warn_and_off(rng):
    """hr_guard='warn' keeps the hr factors (health attached, past tau);
    'off' runs no check and attaches no health."""
    b = _near_singular(rng)
    cfg = QRConfig(nb=32, square_method="hr", hr_guard="warn")
    with pytest.warns(UserWarning, match="hr guard"):
        f = tileqr.qr_factor(b, cfg)
    assert type(f).__name__ == "HRFactors"
    h = float(f.health)
    assert not (h <= cfg.hr_guard_tau)  # NaN or ≫ tau, either trips
    f2 = tileqr.qr_factor(b, QRConfig(nb=32, square_method="hr", hr_guard="off"))
    assert type(f2).__name__ == "HRFactors" and f2.health is None


def test_hr_guard_healthy_keeps_hr(rng):
    """Well-conditioned input under the default guard: stays hr, no
    warning, health is a tiny concrete scalar on the factors."""
    a = rng.standard_normal((160, 128)).astype(np.float32)
    import warnings as _w

    with _w.catch_warnings():
        _w.simplefilter("error")  # any warning fails the test
        f = tileqr.qr_factor(a, QRConfig(nb=32, square_method="hr"))
    assert type(f).__name__ == "HRFactors"
    assert float(f.health) < 1e-3


def test_hr_guard_skipped_under_jit(rng):
    """Inside a jax.jit trace health is a tracer — the host check must be
    skipped silently (no TracerBoolConversionError), with the device
    scalar still flowing for callers to gate on."""
    b = _near_singular(rng)
    cfg = QRConfig(nb=32, square_method="hr")

    @jax.jit
    def f(x):
        fac = tileqr.qr_factor(x, cfg)
        return fac.r, fac.health

    r, h = f(jnp.asarray(b))
    assert r.shape == (128, 128)
    assert not (float(h) <= cfg.hr_guard_tau)  # signal survives the jit


def test_hr_guard_config_validation():
    with pytest.raises(ValueError):
        QRConfig(hr_guard="nope")
