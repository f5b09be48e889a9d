"""Modified LU for Householder reconstruction (the serial step of the
``square_method="hr"`` drivers, drivers/square_hr.py).

Given the top nb×nb block of a panel's orthonormal factor Q1 (from
CholeskyQR2), factor

    Q1_top − diag(d) = L1 · U

with L1 unit lower triangular, U upper triangular, and the sign
modification d_j = −sign(pivot at step j) chosen ON THE FLY so every pivot
satisfies |u_jj| = |q_jj − d_j| ≥ 1 (entries of an orthonormal block are
≤ 1 in magnitude, and d_j has the opposite sign). This is the
Ballard/Demmel/Grigori/Knight "reconstruct Householder vectors from TSQR"
LU. No pivoting is needed: the sign choice bounds the pivots to [1, 2].

The elimination is a ``lax.fori_loop`` over the columns, ``unroll`` steps
per loop iteration. A statically unrolled (recursive blocked) form runs
faster alone, but every panel of a driver inlines its own copy, and its
compile time grows with nb per panel (PERF.md).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# columns eliminated per loop iteration (PERF.md modlu sweep)
UNROLL = 8


@functools.partial(jax.jit, static_argnames=("unroll",))
def modified_lu(q_top: jnp.ndarray, unroll: int = UNROLL):
    """Factor q_top − diag(d) = L1·U with on-the-fly signs.

    q_top: (nb, nb), the top block of an orthonormal panel factor.
    Returns (lu, d): lu holds L1 strictly below the diagonal (unit diagonal
    implicit) and U on/above it; d is the (nb,) sign vector (entries ±1).
    """
    n, n2 = q_top.shape
    if n != n2:
        raise ValueError(f"modified_lu expects a square block, got {q_top.shape}")
    dt = q_top.dtype
    idx = jnp.arange(n)
    one = jnp.ones((), dt)
    zero = jnp.zeros((), dt)

    def step(j, carry):
        a, d = carry
        row = jax.lax.dynamic_index_in_dim(a, j, 0, keepdims=False)
        col = jax.lax.dynamic_index_in_dim(a, j, 1, keepdims=False)
        piv0 = jax.lax.dynamic_index_in_dim(row, j, 0, keepdims=False)
        dj = jnp.where(piv0 > 0, -one, one)
        piv = piv0 - dj
        lcol = jnp.where(idx > j, col / piv, zero)
        urow = jnp.where(idx > j, row, zero)
        a = a - lcol[:, None] * urow[None, :]
        a = jnp.where((idx[:, None] == j) & (idx[None, :] == j), piv, a)
        a = jnp.where((idx[:, None] > j) & (idx[None, :] == j), lcol[:, None], a)
        return a, jnp.where(idx == j, dj, d)

    return jax.lax.fori_loop(
        0, n, step, (q_top, jnp.zeros((n,), dt)), unroll=max(1, min(unroll, n))
    )
