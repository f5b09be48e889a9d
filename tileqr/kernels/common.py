"""Shared helpers for the tile ops: precision names, accumulation dtype,
matmuls with an explicit precision, and triangle masks."""

from __future__ import annotations

import jax
import jax.numpy as jnp

_PRECISIONS = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
}

HIGHEST = jax.lax.Precision.HIGHEST


def resolve_precision(name):
    """Precision name → ``lax.Precision``. On the GPU a float32 product at
    "default" may run in TF32 (about three decimal digits); "highest" keeps
    full float32 and is what every accuracy gate assumes."""
    if isinstance(name, jax.lax.Precision):
        return name
    if name not in _PRECISIONS:
        raise ValueError(f"precision={name!r} must be one of {sorted(_PRECISIONS)}")
    return _PRECISIONS[name]


def acc_type(dt):
    """Accumulation dtype for matmuls: float32 for float32/bfloat16 operands;
    float64 operands (the CPU test oracles) accumulate in float64, or the
    whole factorization would silently round to float32 accuracy."""
    return dt if dt == jnp.float64 else jnp.float32


def dot_general(a, b, dims, precision):
    """``lax.dot_general`` with dtype-matched accumulation, cast back to a's
    dtype."""
    out = jax.lax.dot_general(
        a, b, dimension_numbers=dims, precision=precision,
        preferred_element_type=acc_type(a.dtype),
    )
    return out.astype(a.dtype)


def dot(a, b, precision):
    """a @ b over the last axis of a and the second-to-last of b, batched
    over any shared leading axes."""
    nbatch = a.ndim - 2
    batch = tuple(range(nbatch))
    return dot_general(a, b, (((a.ndim - 1,), (nbatch,)), (batch, batch)), precision)


def bdot_pair_rows(x, y, precision, blk: int = 512, cap_bytes: int = 2 << 30):
    """xᵀ @ y contracting the row axis of (…, m, p) × (…, m, q) → (…, p, q),
    batched over any shared leading axes, without materializing xᵀ.

    A float32 GEMM accumulates its contraction sequentially, so its error
    grows as √m·eps; over the thousands of rows of a panel that alone breaks
    the 1e-6 residual gate. Tall contractions therefore run as one batched
    GEMM over row blocks of ``blk`` rows whose partials are summed pairwise
    (binary tree, in the accumulation dtype): the error drops to
    ~√(blk + log m)·eps. The block count is capped so the partials stay
    under ``cap_bytes``; past it the blocks grow taller. 2 GiB keeps 512-row
    blocks for a whole 32768-column trailing update at nb = 256, the
    setting under which the hh and hr factorizations met the gate there
    (PERF.md). Fewer than two blocks take the plain contraction."""
    nbatch = x.ndim - 2
    batch = tuple(range(nbatch))
    lead = x.shape[:-2]
    m, p = x.shape[-2:]
    q = y.shape[-1]
    nlead = 1
    for s in lead:
        nlead *= s
    size = jnp.dtype(acc_type(x.dtype)).itemsize
    nblk = min(m // blk, max(1, cap_bytes // max(1, nlead * p * q * size)))
    if nblk < 2:
        return dot_general(x, y, (((nbatch,), (nbatch,)), (batch, batch)), precision)
    be = (m // nblk) // 8 * 8
    body = nblk * be
    px = x[..., :body, :].reshape(*lead, nblk, be, p)
    py = y[..., :body, :].reshape(*lead, nblk, be, q)
    bdims = tuple(range(nbatch + 1))
    parts = jax.lax.dot_general(
        px, py, (((nbatch + 1,), (nbatch + 1,)), (bdims, bdims)),
        precision=precision, preferred_element_type=acc_type(x.dtype),
    )  # (…, nblk, p, q)
    if body < m:
        tail = jax.lax.dot_general(
            x[..., body:, :], y[..., body:, :], (((nbatch,), (nbatch,)), (batch, batch)),
            precision=precision, preferred_element_type=acc_type(x.dtype),
        )
        parts = jnp.concatenate([parts, tail[..., None, :, :]], axis=nbatch)
    while parts.shape[nbatch] > 1:
        n2 = parts.shape[nbatch] // 2
        even = jax.lax.slice_in_dim(parts, 0, 2 * n2, 2, axis=nbatch)
        odd = jax.lax.slice_in_dim(parts, 1, 2 * n2, 2, axis=nbatch)
        rest = jax.lax.slice_in_dim(parts, 2 * n2, parts.shape[nbatch], axis=nbatch)
        parts = jnp.concatenate([even + odd, rest], axis=nbatch)
    return jnp.squeeze(parts, axis=nbatch).astype(x.dtype)


def _rows_cols(shape):
    rows = jax.lax.broadcasted_iota(jnp.int32, shape[-2:], 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, shape[-2:], 1)
    return rows, cols


def unit_lower(packed: jnp.ndarray) -> jnp.ndarray:
    """V = strictly-lower(packed) + I — the implicit-unit-diagonal convention
    of LAPACK GEQRT packed output (ref/tile_ops.py). Batched over leading
    axes."""
    rows, cols = _rows_cols(packed.shape)
    one = jnp.ones((), packed.dtype)
    zero = jnp.zeros((), packed.dtype)
    return jnp.where(rows > cols, packed, jnp.where(rows == cols, one, zero))


def triu(a: jnp.ndarray) -> jnp.ndarray:
    """Upper triangle (diagonal included), batched over leading axes."""
    rows, cols = _rows_cols(a.shape)
    return jnp.where(rows <= cols, a, jnp.zeros_like(a))
