"""TSQR tall-leaf / wide-arity tree driver tests (drivers/tsqr.py).

Forces small leaf_rows so multi-level trees, non-power-of-arity survivor
counts (remainders), the arity cap (leaf_rows // n), and both apply-Q
directions are exercised on the CPU backend."""

import jax.numpy as jnp
import numpy as np
import pytest

from tileqr.drivers.tsqr import (
    LEAF_ROWS,
    _tree_plan,
    auto_leaf_rows,
    leaf_geqrt,
    tsqr_apply_q,
    tsqr_factor,
    tsqr_form_q,
)
from tileqr.ref import tile_ops as ops


def _signfix(r, rn):
    s = np.sign(np.diag(rn)) * np.sign(np.diag(r))
    s[s == 0] = 1
    return r * s[:, None]


@pytest.mark.parametrize("p,arity", [(2, 2), (7, 2), (8, 4), (11, 8), (16, 8)])
def test_tree_r_matches_numpy(rng, p, arity):
    n, lr = 32, 96  # leaf_rows // n = 3 caps the arity at 3 for arity >= 4
    a = rng.standard_normal((p * lr, n)).astype(np.float32)
    f = tsqr_factor(jnp.asarray(a), nb=128, leaf_rows=lr, arity=arity)
    rn = np.linalg.qr(a, mode="r")
    r = _signfix(np.asarray(f.r, np.float64), rn)
    assert np.linalg.norm(r - rn) / np.linalg.norm(rn) < 1e-5


def test_tree_plan_static_structure():
    # 11 leaves, arity cap 3: 11 -> (3 combines of 3, rem 2) -> 5 -> 1 ...
    plan = _tree_plan(11, 32, 96, 8)
    cnt = 11
    for ncomb, a_l, flat, rem in plan:
        assert 2 <= a_l <= 3
        assert len(flat) == ncomb * a_l
        assert sorted(flat + rem) == list(flat + rem)  # ascending survivors
        cnt = ncomb + len(rem)
    assert cnt == 1


def test_apply_q_roundtrip(rng):
    p, n, lr = 5, 32, 64
    a = rng.standard_normal((p * lr, n)).astype(np.float32)
    f = tsqr_factor(jnp.asarray(a), nb=128, leaf_rows=lr, arity=4)
    c = rng.standard_normal((p * lr, 16)).astype(np.float32)
    qtc = tsqr_apply_q(f, jnp.asarray(c), trans=True)
    back = np.asarray(tsqr_apply_q(f, qtc, trans=False), np.float64)
    assert np.linalg.norm(back - c) / np.linalg.norm(c) < 1e-5
    # QtA top n rows == R
    qta = np.asarray(tsqr_apply_q(f, jnp.asarray(a), trans=True), np.float64)
    assert np.linalg.norm(qta[:n] - np.asarray(f.r)) / np.linalg.norm(a) < 1e-5
    assert np.linalg.norm(qta[n:]) / np.linalg.norm(a) < 1e-5


def test_form_q_orthonormal_and_reconstructs(rng):
    p, n, lr = 6, 24, 72
    a = rng.standard_normal((p * lr, n)).astype(np.float32)
    f = tsqr_factor(jnp.asarray(a), nb=128, leaf_rows=lr, arity=3)
    q = np.asarray(tsqr_form_q(f), np.float64)
    assert np.linalg.norm(q.T @ q - np.eye(n)) < 1e-4
    r = np.asarray(f.r, np.float64)
    assert np.linalg.norm(q @ np.triu(r) - a) / np.linalg.norm(a) < 1e-5


def test_auto_leaf_rows_bounds():
    assert auto_leaf_rows(1048576, 512) == LEAF_ROWS
    lr = auto_leaf_rows(1024, 64)
    assert lr == 1024  # capped by m
    assert auto_leaf_rows(10**7, 8) % 8 == 0


def test_auto_leaf_rows_floors_at_2n():
    """The tree precondition leaf_rows >= 2n must hold for any n; leaves
    stay 8-row aligned."""
    from tileqr.drivers.tsqr import auto_leaf_rows

    lr = auto_leaf_rows(4608, 1536)
    assert lr >= 2 * 1536 and lr % 8 == 0
    lr = auto_leaf_rows(10**6, 192)
    assert lr % 128 == 0


def test_large_n_tree_path(rng):
    """tsqr factor mode on a wide panel (n=1152): 2n leaves + tree."""
    import jax.numpy as jnp

    from tileqr.drivers.tsqr import auto_leaf_rows, tsqr_factor

    n = 1152
    lr = 2 * n
    a = rng.standard_normal((2 * lr, n)).astype(np.float32)
    f = tsqr_factor(jnp.asarray(a), nb=n, leaf_rows=lr)
    rn = np.linalg.qr(a, mode="r")
    r = np.asarray(f.r)
    s = np.sign(np.diag(rn)) * np.sign(np.diag(r))
    s[s == 0] = 1
    assert np.linalg.norm(r * s[:, None] - rn) / np.linalg.norm(rn) < 5e-5


def test_tree_levels_allow_non8_n(rng):
    """Tree-level combine stacks whose a_l*n is not a multiple of 8 are
    factored like any other."""
    import jax.numpy as jnp

    a = rng.standard_normal((288, 12)).astype(np.float32)
    f = tsqr_factor(jnp.asarray(a), nb=16, leaf_rows=48)
    rn = np.linalg.qr(a, mode="r")
    r = np.asarray(f.r)
    s = np.sign(np.diag(rn)) * np.sign(np.diag(r))
    s[s == 0] = 1
    assert np.linalg.norm(r * s[:, None] - rn) / np.linalg.norm(rn) < 5e-5




@pytest.mark.parametrize("lr", [64, 256])
def test_leaf_geqrt_vs_oracle(rng, lr):
    """The batched leaf factorization equals the oracle GEQRT of every leaf,
    at two leaf heights."""
    n = 32
    a = rng.standard_normal((4 * lr, n)).astype(np.float32)
    packed, t = leaf_geqrt(jnp.asarray(a), lr)
    for i in range(4):
        pk_ref, t_ref = ops.geqrt(a[i * lr : (i + 1) * lr])
        got = np.asarray(packed)[i * lr : (i + 1) * lr]
        assert np.linalg.norm(got - pk_ref) / np.linalg.norm(pk_ref) < 5e-6
        assert np.linalg.norm(np.asarray(t[i]) - t_ref) / np.linalg.norm(t_ref) < 5e-6
