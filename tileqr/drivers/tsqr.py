"""Tall-skinny TSQR driver (reference component C8, SURVEY.md §3.2;
BASELINE.json:9 config — 1048576×512).

The reference splits an M×n panel into row-block leaves, GEQRTs every leaf,
then runs TTQRT tree levels to one R — the communication-avoiding CAQR
reduction [BASELINE.json:5, PAPERS.md Demmel CAQR]. Here:

  * the leaves are ONE batched Householder call over the (p, leaf_rows, n)
    stack (kernels/tile_ops.geqrt: ``lax.linalg.geqrf`` + the Gram-solve T);
  * each tree level stacks up to ``arity`` surviving R factors and factors
    the (ncomb, a·n, n) stacks with the same batched call — a wide-arity
    TTQRT that eliminates a−1 R's per combine.

Tree shape (grouping, arity per level, survivor order) is a static function
of (M, n, leaf_rows, arity) — fixed shapes, deterministic outputs
[BASELINE.json:5 "bitwise-stable"].

Apply-Qᵀ replays leaves then levels on the group-stacked top slices of the
target, all compact-WY matmuls (kernels/tile_ops.larfb).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from tileqr.kernels.common import acc_type, resolve_precision, triu
from tileqr.kernels.tile_ops import geqrt, larfb


class TSQRFactors(NamedTuple):
    """packed_leaves: (M, n) leaf reflectors (packed GEQRT form per leaf);
    t_leaves: (p, n, n) leaf compact-WY T factors; levels: per tree level
    (packed (ncomb, a·n, n), t (ncomb, n, n), survivors_before, arity);
    r: (n, n) final factor; shape: the caller's unpadded (M, n).

    Registered as a jax pytree whose int fields (leaf_rows, shape, plan,
    level counts) are STATIC aux data, so factors pass through ``jax.jit``
    boundaries as arguments — closing over a factor instead bakes its
    arrays into the HLO as multi-GiB constants (3.6 GB at the 1048576×512
    config)."""

    packed_leaves: jnp.ndarray
    t_leaves: jnp.ndarray
    levels: Tuple
    r: jnp.ndarray
    leaf_rows: int
    shape: Tuple[int, int]
    plan: Tuple  # static _tree_plan output, parallel to ``levels``


def _tsqr_factors_flatten(f: TSQRFactors):
    lvl_arrays = tuple((pk, tl) for pk, tl, _, _ in f.levels)
    lvl_static = tuple((cnt, a) for _, _, cnt, a in f.levels)
    return (
        (f.packed_leaves, f.t_leaves, lvl_arrays, f.r),
        (lvl_static, f.leaf_rows, f.shape, f.plan),
    )


def _tsqr_factors_unflatten(aux, children):
    lvl_static, leaf_rows, shape, plan = aux
    packed, ts, lvl_arrays, r = children
    levels = tuple(
        (pk, tl, cnt, a) for (pk, tl), (cnt, a) in zip(lvl_arrays, lvl_static)
    )
    return TSQRFactors(packed, ts, levels, r, leaf_rows, shape, plan)


jax.tree_util.register_pytree_node(
    TSQRFactors, _tsqr_factors_flatten, _tsqr_factors_unflatten
)


# Leaf height: the leaves are factored by one batched geqrf, so a leaf is
# bounded only by the tree precondition (>= 2n rows). The batched geqrf of
# many short leaves is slow on the GPU (PERF.md sweep at 1048576×512: 12 s
# for 128 leaves of 8192 rows, 0.13 s for 4 of 262144), so leaves are tall.
LEAF_ROWS = 262144


def auto_leaf_rows(m: int, n: int) -> int:
    """Leaf height for an (m, n) TSQR: LEAF_ROWS, floored at 2n so the tree
    precondition (a leaf holds two stacked R factors) holds for any n, and
    capped at m (rounded to a multiple of 8)."""
    target = max(LEAF_ROWS, 2 * n)
    target += -target % 8
    return max(8, min(m, target))


def leaf_geqrt(a, leaf_rows: int, precision=jax.lax.Precision.HIGHEST):
    """Factor every ``leaf_rows``-row block of a (M, n), M % leaf_rows == 0,
    in one batched call. Returns (packed (M, n), T (p, n, n))."""
    m, n = a.shape
    p = m // leaf_rows
    packed, t = geqrt(a.reshape(p, leaf_rows, n), precision)
    return packed.reshape(m, n), t


def _tree_plan(p: int, n: int, leaf_rows: int, arity: int):
    """Static tree: per level (groups, a_l, flat_idx, rem_idx) over ORIGINAL
    leaf indices; survivors stay ascending (group reps then remainder)."""
    a_cap = max(2, min(arity, leaf_rows // n))
    levels = []
    idx = list(range(p))
    while len(idx) > 1:
        a_l = min(a_cap, len(idx))
        ncomb = len(idx) // a_l
        flat = idx[: ncomb * a_l]
        rem = idx[ncomb * a_l :]
        reps = flat[::a_l]
        levels.append((ncomb, a_l, tuple(flat), tuple(rem)))
        idx = sorted(reps + rem)
    return levels


@functools.partial(
    jax.jit, static_argnames=("nb", "leaf_rows", "arity", "shape")
)
def tsqr_factor(
    a: jnp.ndarray,
    nb: int,
    leaf_rows: int | None = None,
    arity: int = 8,
    shape: Tuple[int, int] | None = None,
) -> TSQRFactors:
    """TSQR-factor a tall-skinny A (M, n) with n <= nb, M % leaf_rows == 0
    (leaf_rows defaults to ``auto_leaf_rows``; api.tsqr pads M). ``shape``
    records the caller's unpadded (M, n) on the factors (default a.shape)."""
    m, n = a.shape
    if n > nb:
        raise ValueError(f"tsqr requires n={n} <= nb={nb}")
    lr = leaf_rows if leaf_rows is not None else auto_leaf_rows(m, n)
    if m % lr:
        raise ValueError(f"M={m} not a multiple of leaf_rows={lr}")
    p = m // lr
    if p > 1 and lr < 2 * n:
        raise ValueError(f"tree needs leaf_rows={lr} >= 2n={2*n}")
    packed, ts = leaf_geqrt(a, lr)
    rs = jax.vmap(triu)(packed.reshape(p, lr, n)[:, :n, :])

    plan = _tree_plan(p, n, lr, arity)
    levels: List = []
    for ncomb, a_l, flat, rem in plan:
        # factor-order invariant: rs rows follow the current survivor list
        stack = rs[: ncomb * a_l].reshape(ncomb * a_l * n, n)
        pk, tl = leaf_geqrt(stack, a_l * n)
        pk = pk.reshape(ncomb, a_l * n, n)
        rnew = jax.vmap(triu)(pk[:, :n, :])
        rs = (
            jnp.concatenate([rnew, rs[ncomb * a_l :]], axis=0)
            if rem
            else rnew
        )
        levels.append((pk, tl, ncomb * a_l + len(rem), a_l))
    return TSQRFactors(
        packed, ts, tuple(levels), rs[0], lr, shape or (m, n), tuple(plan)
    )


@functools.partial(jax.jit, static_argnames=("trans", "precision"))
def tsqr_apply_q(
    f: TSQRFactors,
    c: jnp.ndarray,
    trans: bool = True,
    precision: str = "highest",
):
    """C ← Qᵀ C (trans) or Q C for the TSQR Q.

    c: (Mc, P) with Mc <= the padded M — ``api.tsqr(mode="factor")`` pads M up
    to a multiple of the auto-selected ``f.leaf_rows`` (a much larger
    granule than nb), so external callers pass c in the ORIGINAL
    row count and the padding/slicing happens here: the pad rows correspond
    to zero rows of the factored input, whose reflector rows are exactly
    zero, so Qᵀ/Q act as the identity on them.
    """
    prec = resolve_precision(precision)
    m, n = f.packed_leaves.shape
    lr = f.leaf_rows
    p = m // lr
    mc, pcols = c.shape
    if mc > m:
        raise ValueError(f"c rows {mc} > factored M {m}")
    c = jnp.pad(c, ((0, m - mc), (0, 0)))
    plan = f.plan

    cb = c.reshape(p, lr, pcols)

    def leaf_apply(packed, t, cblk):
        return larfb(packed, t, cblk, trans, prec)

    def level_apply(tops, level, packed_lvl, t_lvl, tr):
        ncomb, a_l, flat, rem = level
        gather = jnp.asarray(flat)
        stack = tops[gather].reshape(ncomb, a_l * n, pcols)
        new = jax.vmap(lambda pk, tm, st: larfb(pk, tm, st, tr, prec))(
            packed_lvl, t_lvl, stack
        )
        return tops.at[gather].set(new.reshape(ncomb * a_l, n, pcols))

    if trans:
        cb = jax.vmap(leaf_apply)(f.packed_leaves.reshape(p, lr, n), f.t_leaves, cb)
        tops = cb[:, :n, :]
        for level, (pk, tl, _cnt, _a) in zip(plan, f.levels):
            tops = level_apply(tops, level, pk, tl, True)
        cb = cb.at[:, :n, :].set(tops)
    else:
        tops = cb[:, :n, :]
        for level, (pk, tl, _cnt, _a) in zip(plan[::-1], f.levels[::-1]):
            tops = level_apply(tops, level, pk, tl, False)
        cb = cb.at[:, :n, :].set(tops)
        cb = jax.vmap(leaf_apply)(f.packed_leaves.reshape(p, lr, n), f.t_leaves, cb)
    return cb.reshape(m, pcols)[:mc]


@functools.partial(jax.jit, static_argnames=("precision",))
def tsqr_form_q(
    f: TSQRFactors, precision: str = "highest"
) -> jnp.ndarray:
    """Reduced Q (M, n) without materializing an M×n identity (the r1 path
    allocated a full eye — 2 GiB at the 1048576×512 config): the tree levels
    act on (p, n, n) top blocks seeded with I_n at the root only, and the
    leaf apply exploits C = [top; 0]:  Q_leaf C = C − V Tᵀ (V₁ᵀ top)."""
    prec = resolve_precision(precision)
    m, n = f.packed_leaves.shape
    lr = f.leaf_rows
    p = m // lr
    plan = f.plan

    tops = jnp.zeros((p, n, n), f.packed_leaves.dtype)
    tops = tops.at[0].set(jnp.eye(n, dtype=f.packed_leaves.dtype))
    for level, (pk, tl, _cnt, _a) in zip(plan[::-1], f.levels[::-1]):
        ncomb, a_l, flat, rem = level
        gather = jnp.asarray(flat)
        stack = tops[gather].reshape(ncomb, a_l * n, n)
        new = jax.vmap(lambda pkx, tm, st: larfb(pkx, tm, st, False, prec))(
            pk, tl, stack
        )
        tops = tops.at[gather].set(new.reshape(ncomb * a_l, n, n))

    def leaf_q(packed, t, top):
        # [top; 0] − V T (V₁ᵀ top): only the (n, n) top block feeds W
        rows = jax.lax.broadcasted_iota(jnp.int32, packed.shape, 0)
        cols = jax.lax.broadcasted_iota(jnp.int32, packed.shape, 1)
        v = jnp.where(rows > cols, packed, jnp.zeros_like(packed)) + jnp.where(
            rows == cols, jnp.ones_like(packed), jnp.zeros_like(packed)
        )
        w = jnp.dot(v[:n].T, top, precision=prec,
                    preferred_element_type=acc_type(packed.dtype)).astype(packed.dtype)
        w = jnp.dot(t, w, precision=prec, preferred_element_type=acc_type(packed.dtype)).astype(
            packed.dtype
        )
        out = -jnp.dot(v, w, precision=prec, preferred_element_type=acc_type(packed.dtype)).astype(
            packed.dtype
        )
        return out.at[:n, :].add(top)

    qb = jax.vmap(leaf_q)(f.packed_leaves.reshape(p, lr, n), f.t_leaves, tops)
    return qb.reshape(m, n)
