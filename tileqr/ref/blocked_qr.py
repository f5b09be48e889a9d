"""CPU reference blocked/tiled QR (L0 oracle, reference component C9).

The reference carries a sequential CPU Householder QR on the same tile layout
used as the correctness oracle for "bitwise-stable tile outputs"
[SURVEY.md §2.1 C9, BASELINE.json:5]. This module is the equivalent: a
sequential numpy driver composing the tile ops of ref/tile_ops.py in the
EXACT operation order of the device drivers (right-looking flat-tree, or the
binary TT tree), so the device path's tile outputs can be compared against it
tile-by-tile. Runs in fp32 (comparison oracle) or fp64 (accuracy oracle).

Factor layout (shared with drivers/square.py):
  * ``packed`` (M, N): tile (k, k) holds R_kk above/on the diagonal and the
    GEQRT v's strictly below; tile (i, k), i > k holds the dense V2 of the
    TSQRT couple (i, k); tiles (k, j), j > k hold R_kj.
  * ``t_geqrt`` (K, nb, nb): compact-WY T of each diagonal GEQRT.
  * ``t_tsqrt`` (K, Mt, nb, nb): T2 of each TSQRT couple (row i, panel k);
    rows i <= k are unused (zero).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from tileqr.ref import tile_ops as ops


def qr_tiled_ref(
    a: np.ndarray, nb: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Right-looking flat-tree tiled QR (reference main path, SURVEY.md §3.1).

    Returns (packed, t_geqrt, t_tsqrt) in the shared factor layout.
    """
    a = np.array(a, copy=True)
    m, n = a.shape
    if m % nb or n % nb:
        raise ValueError(f"shape {a.shape} not a multiple of nb={nb}")
    mt, nt = m // nb, n // nb
    k_max = min(mt, nt)
    dt = a.dtype
    t_geqrt = np.zeros((k_max, nb, nb), dtype=dt)
    t_tsqrt = np.zeros((k_max, mt, nb, nb), dtype=dt)

    def tile(i, j):
        return a[i * nb : (i + 1) * nb, j * nb : (j + 1) * nb]

    for k in range(k_max):
        # GEQRT on the diagonal tile
        packed_kk, t_k = ops.geqrt(tile(k, k))
        tile(k, k)[:] = packed_kk
        t_geqrt[k] = t_k
        # LARFB across the panel row
        for j in range(k + 1, nt):
            tile(k, j)[:] = ops.larfb(packed_kk, t_k, tile(k, j))
        # flat-tree column elimination + trailing updates
        for i in range(k + 1, mt):
            r_kk = np.triu(tile(k, k)[:, :])
            r_new, v2, t2 = ops.tsqrt(r_kk, tile(i, k))
            # R_kk lives above the diagonal; GEQRT v's below it are kept
            tile(k, k)[:] = np.triu(r_new) + np.tril(tile(k, k), -1)
            tile(i, k)[:] = v2
            t_tsqrt[k, i] = t2
            for j in range(k + 1, nt):
                c_top, c_bot = ops.ssrfb(v2, t2, tile(k, j), tile(i, j))
                tile(k, j)[:] = c_top
                tile(i, j)[:] = c_bot
    return a, t_geqrt, t_tsqrt


def apply_q_ref(
    packed: np.ndarray,
    t_geqrt: np.ndarray,
    t_tsqrt: np.ndarray,
    c: np.ndarray,
    nb: int,
    trans: bool = True,
) -> np.ndarray:
    """Apply Q^T (trans=True) or Q (False) from flat-tree factors to C (M×P).

    Q^T replays the factorization's reflector order forward; Q applies it in
    reverse [LIT: LAPACK xORMQR semantics on the tiled factors].
    """
    c = np.array(c, copy=True)
    m, n = packed.shape
    mt, nt = m // nb, n // nb
    k_max = min(mt, nt)

    def ptile(i, j):
        return packed[i * nb : (i + 1) * nb, j * nb : (j + 1) * nb]

    def ctile(i):
        return c[i * nb : (i + 1) * nb, :]

    def step(k, forward):
        if forward:
            ctile(k)[:] = ops.larfb(ptile(k, k), t_geqrt[k], ctile(k), trans=True)
            for i in range(k + 1, mt):
                top, bot = ops.ssrfb(ptile(i, k), t_tsqrt[k, i], ctile(k), ctile(i), trans=True)
                ctile(k)[:] = top
                ctile(i)[:] = bot
        else:
            for i in range(mt - 1, k, -1):
                top, bot = ops.ssrfb(ptile(i, k), t_tsqrt[k, i], ctile(k), ctile(i), trans=False)
                ctile(k)[:] = top
                ctile(i)[:] = bot
            ctile(k)[:] = ops.larfb(ptile(k, k), t_geqrt[k], ctile(k), trans=False)

    if trans:
        for k in range(k_max):
            step(k, forward=True)
    else:
        for k in range(k_max - 1, -1, -1):
            step(k, forward=False)
    return c


def qr_ref(a: np.ndarray, nb: int) -> Tuple[np.ndarray, np.ndarray]:
    """Full reference QR: returns (Q, R) with Q M×M via apply to identity."""
    packed, t_g, t_t = qr_tiled_ref(a, nb)
    m, n = a.shape
    q = apply_q_ref(packed, t_g, t_t, np.eye(m, dtype=a.dtype), nb, trans=False)
    r = np.triu(packed)
    return q, r


def tsqr_ref(a: np.ndarray, nb: int) -> Tuple[np.ndarray, list]:
    """Tall-skinny TSQR binary tree (reference path C8, SURVEY.md §3.2).

    a is (M, n) with n <= nb and M a multiple of nb. Returns (R, tree) where
    tree = [(packed_leaves, t_leaves), (v2_level, t2_level), ...] — the leaf
    GEQRT factors followed by per-level TTQRT factors, enough to apply Q^T.
    The tree shape is FIXED (pair t with t+half at each level) for
    deterministic output (BASELINE.json:5 "bitwise-stable").
    """
    m, n = a.shape
    if m % nb:
        raise ValueError(f"M={m} not a multiple of nb={nb}")
    p = m // nb
    dt = a.dtype
    leaves_packed = np.zeros((p, nb, n), dtype=dt)
    leaves_t = np.zeros((p, n, n), dtype=dt)
    rs = np.zeros((p, n, n), dtype=dt)
    for t in range(p):
        pk, tk = ops.geqrt(a[t * nb : (t + 1) * nb, :])
        leaves_packed[t] = pk
        leaves_t[t] = tk
        rs[t] = np.triu(pk[:n, :])
    tree = [(leaves_packed, leaves_t)]
    cnt = p
    while cnt > 1:
        half = (cnt + 1) // 2
        v2s = np.zeros((half, n, n), dtype=dt)
        t2s = np.zeros((half, n, n), dtype=dt)
        merged = np.zeros((half, n, n), dtype=dt)
        for t in range(half):
            if t + half < cnt:
                r_new, v2, t2 = ops.ttqrt(rs[t], rs[t + half])
                merged[t] = np.triu(r_new)
                v2s[t] = v2
                t2s[t] = t2
            else:
                merged[t] = rs[t]  # odd survivor passes through
        tree.append((v2s, t2s))
        rs = merged
        cnt = half
    return rs[0], tree
