"""Integration tier (SURVEY.md §4): full tiled QR driver vs the L0 oracle —
tile-level agreement, reconstruction, orthogonality, determinism."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tileqr.drivers.square import apply_q_tiled, assemble_r, qr_tiled
from tileqr.ref import blocked_qr as refqr


def factor(a, nb, chunk=1):
    return qr_tiled(jnp.asarray(a), nb, chunk=chunk)


@pytest.mark.parametrize(
    "m,n,nb",
    [
        # fast tier: square multi-panel (3×3), Mt>Nt, Nt>Mt — every tile-
        # grid orientation at the minimum panel counts that exercise the
        # full couple/update algebra; the 4×4 square case (~2.5× the
        # cost of 3×3, no new code path) is the slow twin
        (192, 192, 64),
        (384, 128, 64),
        (128, 256, 64),
        pytest.param(256, 256, 64, marks=pytest.mark.slow),
    ],
)
def test_matches_oracle_tile_by_tile(rng, m, n, nb):
    """chunk=1 reproduces the reference flat-tree algebra: R and every
    reflector tile agree with the numpy oracle."""
    a = rng.standard_normal((m, n)).astype(np.float32)
    packed, r_diag, t_g, panels = factor(a, nb)
    r = np.asarray(assemble_r(packed, r_diag, nb))
    pk_ref, tg_ref, tt_ref = refqr.qr_tiled_ref(a, nb)
    r_ref = np.triu(pk_ref)
    assert np.linalg.norm(r - r_ref) / np.linalg.norm(r_ref) < 5e-6
    mt = m // nb
    k_max = min(mt, n // nb)
    for k in range(k_max):
        packed_kk, couples = panels[k]
        # GEQRT packed tile
        want = pk_ref[k * nb : (k + 1) * nb, k * nb : (k + 1) * nb]
        got = np.asarray(packed_kk)
        # oracle keeps the final R in the diagonal tile; compare the V part
        assert np.linalg.norm(np.tril(got, -1) - np.tril(want, -1)) <= 2e-5 * max(
            np.linalg.norm(np.tril(want, -1)), 1e-6
        )
        # chunk=1: every sub-diagonal V2 tile is one couple
        assert len(couples) == mt - k - 1
        for i in range(mt - k - 1):
            want = pk_ref[(k + 1 + i) * nb : (k + 2 + i) * nb, k * nb : (k + 1) * nb]
            got = np.asarray(couples[i][0])
            assert np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-20) < 2e-5
        assert np.linalg.norm(np.asarray(t_g[k]) - tg_ref[k]) / max(
            np.linalg.norm(tg_ref[k]), 1e-20
        ) < 2e-5


def test_reconstruction_and_orthogonality(rng):
    m = n = 256
    nb = 64
    a = rng.standard_normal((m, n)).astype(np.float32)
    packed, r_diag, t_g, panels = factor(a, nb)
    r = np.asarray(assemble_r(packed, r_diag, nb)).astype(np.float64)
    q = np.asarray(
        apply_q_tiled(panels, t_g, np.eye(m, dtype=np.float32), nb, trans=False)
    ).astype(np.float64)
    assert np.linalg.norm(a - q @ r) / np.linalg.norm(a) < 2e-6
    assert np.linalg.norm(q.T @ q - np.eye(m)) < 1e-4


def test_qt_then_q_roundtrip(rng):
    m, n, nb = 192, 128, 64
    a = rng.standard_normal((m, n)).astype(np.float32)
    packed, r_diag, t_g, panels = factor(a, nb)
    c = rng.standard_normal((m, 64)).astype(np.float32)
    qtc = apply_q_tiled(panels, t_g, jnp.asarray(c), nb, trans=True)
    back = np.asarray(apply_q_tiled(panels, t_g, qtc, nb, trans=False))
    assert np.linalg.norm(back - c) / np.linalg.norm(c) < 5e-6


def _check_chunked_reconstruction(rng, m, n, nb, chunks):
    """chunk != 1 (tall couples; 0 = one couple per panel) is a different,
    equally valid Householder factorization: verify reconstruction +
    orthogonality + QᵀA = R."""
    a = rng.standard_normal((m, n)).astype(np.float32)
    for chunk in chunks:
        packed, r_diag, t_g, panels = qr_tiled(jnp.asarray(a), nb, chunk=chunk)
        r = np.asarray(assemble_r(packed, r_diag, nb)).astype(np.float64)
        q = np.asarray(
            apply_q_tiled(panels, t_g, np.eye(m, dtype=np.float32), nb, trans=False)
        ).astype(np.float64)
        assert np.linalg.norm(a - q @ r) / np.linalg.norm(a) < 2e-6, chunk
        assert np.linalg.norm(q.T @ q - np.eye(m)) < 1e-4, chunk
        qta = np.asarray(
            apply_q_tiled(panels, t_g, jnp.asarray(a), nb, trans=True)
        ).astype(np.float64)
        assert np.linalg.norm(qta - r) / np.linalg.norm(a) < 2e-6, chunk


def test_chunked_reconstruction(rng):
    """Fast tier: chunk=2 at 3×3 panels sees both a FULL couple
    (k=0: two sub-diagonal tiles → one couple of 2) and a ragged tail
    (k=1: one tile); chunk=0 folds each panel's sub-diagonal into one
    couple. The 4×4/chunk=4 geometry is the slow twin below."""
    _check_chunked_reconstruction(rng, 192, 192, 64, (2, 0))


@pytest.mark.slow
def test_chunked_reconstruction_chunk4(rng):
    _check_chunked_reconstruction(rng, 256, 256, 64, (2, 4))


def test_bitwise_determinism(rng):
    """BASELINE.json:5 'bitwise-stable tile outputs': same backend, same
    inputs → identical bits (doubles as a race detector, SURVEY.md §5)."""
    a = rng.standard_normal((256, 256)).astype(np.float32)
    out1 = factor(a, 64, chunk=4)
    out2 = factor(a, 64, chunk=4)
    for x, y in zip(jax.tree_util.tree_leaves(out1), jax.tree_util.tree_leaves(out2)):
        assert (np.asarray(x) == np.asarray(y)).all()


def test_orgqr_triangular_window_matches_full_apply(rng):
    """apply_q_tiled(triangular=True) on an identity must equal the full
    sweep bitwise-closely: panel k's skipped column tiles < k are exact
    no-ops (W sums over all-zero rows), so the windowed result is the same
    computation minus provably-zero work."""
    import jax.numpy as jnp

    from tileqr.drivers.square import apply_q_tiled, qr_tiled

    a = jnp.asarray(rng.standard_normal((192, 192)).astype(np.float32))
    _, _, tg, panels = qr_tiled(a, 64, chunk=1)
    eye = jnp.eye(192, dtype=jnp.float32)
    full = np.asarray(
        apply_q_tiled(panels, tg, eye, 64, trans=False)
    )
    tri = np.asarray(
        apply_q_tiled(panels, tg, eye, 64, trans=False, triangular=True)
    )
    assert (full == tri).all()


@pytest.mark.parametrize("m,n,nb,segments", [
    (192, 192, 32, 2),   # square, two segments of three panels
    (256, 160, 32, 3),   # tall: rows below the last panel
    (160, 256, 32, 2),   # wide: columns right of the last panel
    (256, 256, 32, 16),  # more segments asked than pairs of panels
])
def test_loop_driver_matches_static(rng, m, n, nb, segments):
    """qr_tiled_loop runs the chunk=0 algebra of qr_tiled with the panel at
    a runtime offset: the same R (same signs), QᵀA = [R; 0] through
    apply_q_loop, and a Q that is orthogonal."""
    from tileqr.drivers.square import apply_q_loop, qr_tiled_loop

    a = rng.standard_normal((m, n)).astype(np.float32)
    packed, r_diag, t_g, stack = qr_tiled_loop(jnp.asarray(a), nb, segments=segments)
    r = np.asarray(assemble_r(packed, r_diag, nb), np.float64)
    p0, d0, _, _ = qr_tiled(jnp.asarray(a), nb, chunk=0)
    r0 = np.asarray(assemble_r(p0, d0, nb), np.float64)
    assert np.abs(r - r0).max() <= 5e-6 * np.abs(r0).max()
    k = min(m, n)
    qta = np.asarray(apply_q_loop(stack, t_g, jnp.asarray(a), nb, trans=True), np.float64)
    assert np.linalg.norm(qta[:k] - r[:k]) / np.linalg.norm(a) < 2e-6
    assert np.linalg.norm(qta[k:]) / np.linalg.norm(a) < 2e-6
    q = np.asarray(apply_q_loop(stack, t_g, jnp.eye(m, dtype=jnp.float32), nb, trans=False),
                   np.float64)
    assert np.linalg.norm(q.T @ q - np.eye(m)) < 1e-4


@pytest.mark.parametrize("k_max,segments,want", [
    (128, 16, 16), (5, 16, 2), (3, 8, 1), (1, 16, 1),
])
def test_loop_segments(k_max, segments, want):
    """Segments cover every panel once, in order, with at least two panels
    each where there are two."""
    from tileqr.drivers.square import loop_segments

    segs = loop_segments(k_max, segments)
    assert len(segs) == want
    assert segs[0][0] == 0 and segs[-1][1] == k_max
    assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))
    assert all(ke - ks >= min(2, k_max) for ks, ke in segs)


def test_api_routes_past_panel_limit_to_loop(rng, monkeypatch):
    """Past square.STATIC_MAX_PANELS (chunk=0) qr_factor takes the loop
    driver; qr, apply_q, orgqr and lstsq all consume its PanelStack."""
    import tileqr
    from tileqr.drivers import square
    from tileqr.drivers.square import PanelStack

    monkeypatch.setattr(square, "STATIC_MAX_PANELS", 2)
    a = rng.standard_normal((160, 128)).astype(np.float32)
    cfg = tileqr.QRConfig(nb=32)
    f = tileqr.qr_factor(a, cfg)
    assert isinstance(f.panels, PanelStack)
    q, r = tileqr.qr(a, config=cfg)
    q64, r64 = np.asarray(q, np.float64), np.asarray(r, np.float64)
    assert np.linalg.norm(q64 @ r64 - a) / np.linalg.norm(a) < 2e-6
    assert np.linalg.norm(q64.T @ q64 - np.eye(128)) < 1e-4
    c = rng.standard_normal((160, 8)).astype(np.float32)
    back = tileqr.apply_q(f, tileqr.apply_q(f, c, trans=True), trans=False)
    assert np.linalg.norm(np.asarray(back) - c) / np.linalg.norm(c) < 2e-6
    b = rng.standard_normal(160).astype(np.float32)
    x = np.asarray(tileqr.lstsq(a, b, config=cfg), np.float64)
    x64 = np.linalg.lstsq(a.astype(np.float64), b.astype(np.float64), rcond=None)[0]
    assert np.linalg.norm(x - x64) / np.linalg.norm(x64) < 1e-4
    # chunk != 0 keeps the unrolled driver at any panel count
    f1 = tileqr.qr_factor(a, cfg.replace(chunk=1))
    assert isinstance(f1.panels, tuple)
