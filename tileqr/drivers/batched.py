"""Batched QR path (BASELINE.json:10 config — 4096 independent 128² fp32
matrices). The whole stack is factored by one batched Householder call and
Q is formed from the compact-WY identity Q = I − V T Vᵀ with batched
matmuls (no reflector replay is needed for one tile)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tileqr.kernels.common import dot, resolve_precision, triu, unit_lower
from tileqr.kernels.tile_ops import geqrt


@functools.partial(jax.jit, static_argnames=("mode", "precision"))
def qr_batched(a: jnp.ndarray, mode: str = "reduced", precision: str = "highest"):
    """Batched QR of a (B, m, n) stack of small matrices, m >= n, through
    one batched geqrf (kernels/tile_ops.geqrt).

    mode: "reduced" → (Q (B, m, n), R (B, n, n)); "r" → R only.
    """
    prec = resolve_precision(precision)
    b, m, n = a.shape
    if n > m:
        raise ValueError("qr_batched requires m >= n")
    packed, t = geqrt(a, prec)
    r = triu(packed[:, :n, :])
    if mode == "r":
        return r
    # reduced Q = (I − V T Vᵀ)[:, :n] = E_n − V (T V₁ᵀ)
    v = unit_lower(packed)
    x = dot(t, jnp.swapaxes(v[:, :n, :], 1, 2), prec)
    eye = jnp.eye(m, n, dtype=a.dtype)
    return eye - dot(v, x, prec), r
