"""Tile-op unit tests (SURVEY.md §4): each plain-XLA tile op
(kernels/tile_ops.py) vs the L0 numpy oracle on random tiles."""

import jax.numpy as jnp
import numpy as np
import pytest

from tileqr.kernels import common
from tileqr.kernels.tile_ops import build_t, geqrt, larfb, ssrfb, tsqrt, ttmqr, ttqrt
from tileqr.ref import tile_ops as ops

TOL = 5e-6  # fp32 relative, op vs oracle (different reduction order)


def rel(got, want):
    got = np.asarray(got)
    den = np.linalg.norm(want)
    return np.linalg.norm(got - want) / (den if den > 0 else 1.0)


@pytest.mark.parametrize("m,n", [(128, 128), (256, 256), (192, 128), (128, 64)])
def test_geqrt_vs_oracle(rng, m, n):
    a = rng.standard_normal((m, n)).astype(np.float32)
    pk, t = geqrt(jnp.asarray(a))
    pk_ref, t_ref = ops.geqrt(a)
    assert rel(pk, pk_ref) < TOL
    assert rel(t, t_ref) < TOL


def test_geqrt_zero_tile():
    pk, t = geqrt(jnp.zeros((128, 64), jnp.float32))
    assert np.allclose(pk, 0) and np.allclose(t, 0)


@pytest.mark.parametrize("m,n,zero_cols", [
    (64, 64, ()), (96, 48, (5,)), (128, 32, (0, 31)), (40, 40, (3, 4, 39)),
])
def test_build_t_vs_oracle(rng, m, n, zero_cols):
    """T from the Gram solve equals the xLARFT recurrence of the oracle,
    including τ = 0 columns (zero columns, as every zero-padded column is),
    whose row and column of T must be zero."""
    a = rng.standard_normal((m, n))
    a[:, list(zero_cols)] = 0.0
    pk_ref, t_ref = ops.geqrt(a)
    taus = np.diag(t_ref).copy()
    for j in zero_cols:
        assert taus[j] == 0.0
    v = ops.unpack_v(pk_ref)
    t = np.asarray(build_t(jnp.asarray(v.T @ v), jnp.asarray(taus)))
    assert np.abs(t - t_ref).max() < 1e-12 * max(1.0, np.abs(t_ref).max()) * m
    for j in zero_cols:
        assert (t[j, :] == 0).all() and (t[:, j] == 0).all()


def test_geqrt_deterministic(rng):
    a = jnp.asarray(rng.standard_normal((128, 128)).astype(np.float32))
    p1, t1 = geqrt(a)
    p2, t2 = geqrt(a)
    assert (np.asarray(p1) == np.asarray(p2)).all()
    assert (np.asarray(t1) == np.asarray(t2)).all()


def test_tsqrt_vs_oracle(rng):
    n, m = 128, 128
    r = np.triu(rng.standard_normal((n, n))).astype(np.float32)
    b = rng.standard_normal((m, n)).astype(np.float32)
    r1, v2, t2 = tsqrt(jnp.asarray(r), jnp.asarray(b))
    rr, vv, tt = ops.tsqrt(r, b)
    assert rel(r1, rr) < TOL and rel(v2, vv) < TOL and rel(t2, tt) < TOL
    # R' strictly-lower part must be exactly zero (structure preserved)
    assert np.allclose(np.tril(np.asarray(r1), -1), 0)


def test_ttqrt_structure(rng):
    n = 128
    r1 = np.triu(rng.standard_normal((n, n))).astype(np.float32)
    r2 = np.triu(rng.standard_normal((n, n))).astype(np.float32)
    ro, v2, t2 = ttqrt(jnp.asarray(r1), jnp.asarray(r2))
    rr, vv, tt = ops.ttqrt(r1, r2)
    assert rel(ro, rr) < TOL
    # TT structure: V2 upper-triangular exactly
    assert np.allclose(np.tril(np.asarray(v2), -1), 0)


@pytest.mark.parametrize("n", [128, 256])
def test_ttqrt_matches_tsqrt_bitwise(rng, n):
    """TTQRT is the generic couple on triangular inputs: the couple
    factorization keeps V2's strict lower part at exact zeros, so the
    structural triu TTQRT applies changes no bit."""
    r1 = jnp.asarray(np.triu(rng.standard_normal((n, n))).astype(np.float32))
    r2 = jnp.asarray(np.triu(rng.standard_normal((n, n))).astype(np.float32))
    ro, v2, t2 = ttqrt(r1, r2)
    rg, vg, tg = tsqrt(r1, r2)
    assert (np.asarray(ro) == np.asarray(rg)).all()
    assert (np.asarray(v2) == np.asarray(vg)).all()
    assert (np.asarray(t2) == np.asarray(tg)).all()


def test_ttmqr_applies_tree_reflectors(rng):
    """TTMQR round-trip: factor [R1; R2], apply Qᵀ to the stacked couple —
    top must become R, and Q orthogonality transfers the Frobenius norm."""
    n = 128
    r1 = jnp.asarray(np.triu(rng.standard_normal((n, n))).astype(np.float32))
    r2 = jnp.asarray(np.triu(rng.standard_normal((n, n))).astype(np.float32))
    ro, v2, t2 = ttqrt(r1, r2)
    top, bot = ttmqr(v2, t2, r1, r2, trans=True)
    assert rel(top, np.asarray(ro)) < TOL
    assert np.linalg.norm(np.asarray(bot)) < TOL * np.linalg.norm(np.asarray(ro))


@pytest.mark.parametrize("trans", [True, False])
def test_larfb_vs_oracle(rng, trans):
    m, n, p = 128, 128, 128
    a = rng.standard_normal((m, n)).astype(np.float32)
    c = rng.standard_normal((m, p)).astype(np.float32)
    pk, t = ops.geqrt(a)
    got = larfb(jnp.asarray(pk), jnp.asarray(t), jnp.asarray(c), trans=trans)
    want = ops.larfb(pk, t, c, trans=trans)
    assert rel(got, want) < TOL


@pytest.mark.parametrize("trans", [True, False])
def test_ssrfb_vs_oracle(rng, trans):
    n, m, p = 128, 128, 128
    r = np.triu(rng.standard_normal((n, n))).astype(np.float32)
    b = rng.standard_normal((m, n)).astype(np.float32)
    _, v2, t2 = ops.tsqrt(r, b)
    ct = rng.standard_normal((n, p)).astype(np.float32)
    cb = rng.standard_normal((m, p)).astype(np.float32)
    gt, gb = ssrfb(*map(jnp.asarray, (v2, t2, ct, cb)), trans=trans)
    wt, wb = ops.ssrfb(v2, t2, ct, cb, trans=trans)
    assert rel(gt, wt) < TOL and rel(gb, wb) < TOL


@pytest.mark.parametrize("a_shape,q", [
    ((4104, 16), 40), ((4096, 16), 40), ((24, 16), 40), ((3, 1500, 8), 12),
    ((2, 3, 1100, 8), 4),
])
def test_pair_rows_leading_axes(rng, a_shape, q):
    """aᵀb over tall row counts (common.bdot_pair_rows): row-block partials
    summed pairwise, a ragged tail block, any number of leading batch axes,
    and short inputs that take the plain contraction — all against
    float64."""
    a = rng.standard_normal(a_shape).astype(np.float32)
    b = rng.standard_normal(a_shape[:-1] + (q,)).astype(np.float32)
    got = np.asarray(common.bdot_pair_rows(jnp.asarray(a), jnp.asarray(b), common.HIGHEST),
                     np.float64)
    want = np.einsum("...ki,...kj->...ij", a.astype(np.float64), b.astype(np.float64))
    assert got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6
