"""Tile-layout math (reference component C6, SURVEY.md §2.1).

The CUDA reference stores the matrix in explicit nb×nb tiled (block) storage
in GPU global memory with per-tile T buffers [SURVEY.md §2.1 C6]. Here the
matrix stays a single row-major (M, N) array and the drivers slice nb×nb
tiles and panels out of it, so no separate tiled layout (or pack/unpack
pass) is needed on one device. The helpers here handle padding to
tile multiples and the block-cyclic tile→device maps used by the sharded
driver (where an explicit tiled layout *is* used, because each device owns a
strided subset of tiles).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def pad_to_tiles(a: jnp.ndarray, nb: int) -> Tuple[jnp.ndarray, Tuple[int, int]]:
    """Zero-pad a 2-D matrix so both dims are multiples of nb.

    Returns the padded matrix and the original (M, N). Zero-padding is safe
    for QR: padded columns/rows produce zero Householder components and an
    R block that is exactly zero, so the leading (M, N) results are the
    factorization of the original matrix when M >= N.
    """
    m, n = a.shape
    mp, np_ = round_up(m, nb), round_up(n, nb)
    if (mp, np_) != (m, n):
        a = jnp.pad(a, ((0, mp - m), (0, np_ - n)))
    return a, (m, n)


def tile_counts(shape: Tuple[int, int], nb: int) -> Tuple[int, int]:
    m, n = shape
    if m % nb or n % nb:
        raise ValueError(f"shape {shape} not a multiple of nb={nb}")
    return m // nb, n // nb


# ---------------------------------------------------------------------------
# Block-cyclic maps for the sharded driver (build-plan addition,
# BASELINE.json:5 "2D block-cyclic sharding"; SURVEY.md §3.4).
# Tile (i, j) lives on device (i % pr, j % pc); device (r, c) stores its
# tiles in a dense local array indexed by (i // pr, j // pc).
# ---------------------------------------------------------------------------


def block_cyclic_owner(i: int, j: int, pr: int, pc: int) -> Tuple[int, int]:
    return i % pr, j % pc


def local_tile_counts(mt: int, nt: int, pr: int, pc: int, r: int, c: int) -> Tuple[int, int]:
    """Number of tiles device (r, c) owns along each tile axis."""
    return cdiv(mt - r, pr), cdiv(nt - c, pc)


def to_block_cyclic(a: np.ndarray, nb: int, pr: int, pc: int) -> np.ndarray:
    """Pack (M, N) → (pr, pc, lmt, lnt, nb, nb) block-cyclic tiled layout.

    Requires M/nb divisible by pr and N/nb divisible by pc (pad first) so
    every device holds the same count of tiles — a static-shape requirement
    for shard_map.
    """
    m, n = a.shape
    mt, nt = m // nb, n // nb
    if mt % pr or nt % pc:
        raise ValueError(f"tile grid ({mt},{nt}) not divisible by mesh ({pr},{pc})")
    t = a.reshape(mt, nb, nt, nb).transpose(0, 2, 1, 3)  # (mt, nt, nb, nb)
    t = t.reshape(mt // pr, pr, nt // pc, pc, nb, nb)
    return t.transpose(1, 3, 0, 2, 4, 5)  # (pr, pc, lmt, lnt, nb, nb)


def from_block_cyclic(t: np.ndarray, nb: int) -> np.ndarray:
    """Inverse of :func:`to_block_cyclic`."""
    pr, pc, lmt, lnt, _, _ = t.shape
    t = t.transpose(2, 0, 3, 1, 4, 5)  # (lmt, pr, lnt, pc, nb, nb)
    mt, nt = lmt * pr, lnt * pc
    t = t.reshape(mt, nt, nb, nb).transpose(0, 2, 1, 3)
    return t.reshape(mt * nb, nt * nb)
