"""2D block-cyclic multi-device tiled QR via shard_map + collectives.

Build-plan addition (BASELINE.json:5 "Add … 2D block-cyclic sharding";
SURVEY.md §3.4 qr_sharded, §5 comm-backend row): the reference is single-GPU
with no distributed layer; this driver scales the same tile algebra across a
2D ``jax.sharding.Mesh`` ('rows', 'cols') with XLA collectives (NCCL on
GPUs) — ``psum`` for the panel-column broadcast, static-permutation
``ppermute`` for the TTQRT reduction tree across mesh rows (the CAQR
communication-avoiding structure: cross-device traffic per panel is one
nb-wide column broadcast plus log2(pr) R-tile exchanges and strip
pair-exchanges, everything else local).

Layout: tile (i, j) of the (Mt, Nt) tile grid lives on device
(i % pr, j % pc); each device stores its tiles as one contiguous local
matrix, so every device's trailing submatrix is a contiguous window of it.

Bounded compile: the panels run in a ``lax.fori_loop`` per segment
(square.loop_segments), so one panel body is compiled per segment whatever
the panel count. Within a segment every device works on its part of the
segment's trailing block, a static local window; panel k's diagonal row on
a device is a runtime offset (tile_ops.panel_factor_at / panel_apply_at),
and the tree's exchanges are the same cyclic shifts for every panel
(``_tree_levels``). Each local matrix is padded with two zero dummy tile
rows/columns, so every device row keeps at least one (zero) tile at or
below each diagonal; zero tiles flow through GEQRT/TSQRT/SSRFB as τ = 0
no-ops. Work on the block's finished rows and columns is the loop's price
(square.py: about 1 + 3/(2·segments) times the update flops).

Per panel k (hierarchical CAQR):
  1. masked-psum broadcast of the panel column along 'cols' → every device
     factors its mesh-row's panel stack REDUNDANTLY (replicated compute
     replaces a (V, T) broadcast — same traffic, simpler);
  2. local chain: GEQRT + one TSQRT couple (tile_ops.panel_factor_at);
  3. binary TTQRT tree over 'rows' (rotated so the tree root is the global
     diagonal owner r_k = k % pr), V2/T2 kept per level;
  4. local trailing update: LARFB + SSRFB (tile_ops.panel_apply_at);
  5. strip-level TTMQR tree over 'rows' mirroring 3 (pair-exchange the
     representative row strips, compact-WY couple matmuls, send halves back);
  6. tree-root R becomes the global diagonal tile (masked psum-replicated).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import AxisType, Mesh, PartitionSpec as P

from tileqr.core.config import QRConfig, mesh_shape_for
from tileqr.core.layout import round_up
from tileqr.drivers.square import loop_segments
from tileqr.kernels.common import resolve_precision, triu
from tileqr.kernels.tile_ops import (
    ix,
    panel_apply_at,
    panel_factor_at,
    ssrfb,
    stack_get,
    stack_put,
    ttqrt,
)


def _to_local_layout(a: jnp.ndarray, nb: int, pr: int, pc: int) -> jnp.ndarray:
    """(M, N) → (pr, pc, lm, ln): block-cyclic local matrices with tile
    (i, j) at local tile (i // pr, j // pc) of device (i % pr, j % pc)."""
    m, n = a.shape
    mt, nt = m // nb, n // nb
    t = a.reshape(mt // pr, pr, nb, nt // pc, pc, nb)
    # (lmt, pr, nb, lnt, pc, nb) → (pr, pc, lmt, nb, lnt, nb)
    t = t.transpose(1, 4, 0, 2, 3, 5)
    return t.reshape(pr, pc, (mt // pr) * nb, (nt // pc) * nb)


def _from_local_layout(t: jnp.ndarray, nb: int) -> jnp.ndarray:
    pr, pc, lm, ln = t.shape
    lmt, lnt = lm // nb, ln // nb
    t = t.reshape(pr, pc, lmt, nb, lnt, nb).transpose(2, 0, 3, 4, 1, 5)
    return t.reshape(lmt * pr * nb, lnt * pc * nb)


def _mesh(shape) -> Mesh:
    # Auto axes: arrays sharded on this mesh may be reshaped into the
    # block-cyclic layout without naming every intermediate's sharding
    return jax.make_mesh(shape, ("rows", "cols"), axis_types=(AxisType.Auto,) * 2)


def make_mesh(config: QRConfig) -> Mesh:
    """The ('rows', 'cols') mesh for ``config``: its mesh_shape, or the
    widest pr >= pc factorization of the visible device count."""
    return _mesh(config.mesh_shape or mesh_shape_for(jax.device_count()))


def mesh_from_factors(local, pr: int, pc: int) -> Mesh:
    """The mesh to run a factor-consuming shard_map on when the caller
    passed none: recovered from the factors' OWN sharding when possible
    (rebuilding with jax.make_mesh's default device order would silently
    reshard factors produced on a caller mesh with a permuted device order:
    correct values, but a full cross-device transfer). Falls back to a
    fresh default mesh for unsharded arrays or mismatched geometry."""
    sh = getattr(local, "sharding", None)
    m = getattr(sh, "mesh", None)
    # isinstance, not hasattr: AbstractMesh.devices RAISES ValueError
    # (which hasattr propagates — it only swallows AttributeError)
    if isinstance(m, Mesh):
        try:
            if (
                tuple(m.axis_names) == ("rows", "cols")
                and tuple(m.devices.shape) == (pr, pc)
            ):
                return m
        except (AttributeError, TypeError):
            pass
    return _mesh((pr, pc))


@functools.partial(jax.jit, static_argnames=("nb", "rows", "cols", "mesh"))
def _unpack_local_jit(t, nb: int, rows: int, cols: int, mesh):
    """Device-native block-cyclic → global unpack. The tile interleave is
    not expressible as a reshape of a GSPMD-sharded array (it would split
    and merge sharded axes), so the gather + unpack runs INSIDE shard_map
    where values are plain per-device arrays: two all_gathers replicate the
    (rows × cols tiles) payload, then the unpack is a local transpose.
    t: (pr, pc, lm, ln) sharded; rows/cols: real tile extents (dummy pads
    dropped before the gather)."""

    def body(tb):
        x = tb[0, 0, : rows * nb, : cols * nb]
        xc = jax.lax.all_gather(x, "cols")  # (pc, rows·nb, cols·nb)
        xrc = jax.lax.all_gather(xc, "rows")  # (pr, pc, …)
        return _from_local_layout(xrc, nb)

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P("rows", "cols"),),
        out_specs=P(),
        check_vma=False,
    )(t)


@functools.partial(jax.jit, static_argnames=("nb", "grid", "shape", "mesh"))
def _assemble_r_jit(local, r_diag, nb: int, grid, shape, mesh):
    mt, nt, pr, pc = grid
    k_max = min(mt, nt)
    full = _unpack_local_jit(local, nb, mt // pr, nt // pc, mesh)
    r = jnp.triu(full)
    rt = r.reshape(mt, nb, nt, nb)
    idx = jnp.arange(k_max)
    rt = rt.at[idx, :, idx, :].set(jax.vmap(jnp.triu)(r_diag))
    m, n = shape
    return rt.reshape(mt * nb, nt * nb)[:m, :n]


class ShardedQRFactors(NamedTuple):
    """Distributed factors. local: (pr, pc, lm, ln) packed local matrices
    (sharded); r_diag: (K, nb, nb) final diagonal R tiles (replicated);
    panels: (packed, tg, t2, tree_v2, tree_t2, v2) — every array with
    leading (pr, pc) device axes: the local chain's GEQRT tiles, T's and
    couple T's (K, nb, nb), the row tree's V2/T2 (K, levels, nb, nb), and
    per segment the couples' V2 (ke − ks, h − nb, nb) in rolled rows
    (kernels/tile_ops.panel_factor_at); segs: the static segment table
    ((ks, ke, lr, lc), …)."""

    local: jnp.ndarray
    r_diag: jnp.ndarray
    panels: Tuple
    nb: int
    shape: Tuple[int, int]
    grid: Tuple[int, int, int, int]  # (mt, nt, pr, pc)
    segs: Tuple[Tuple[int, int, int, int], ...] = ()


def _tree_levels(pr: int):
    """The row tree's levels d = 1, 2, 4, … < pr as static cyclic shifts:
    (down, up, d), down sending every device row r to r − d and up to r + d.
    The tree is rotated so that its root is the panel's diagonal owner
    (rotated index t = (r − r_k) % pr); a device reads what it receives
    only where t's place in the tree says so, which keeps the permutations
    the same for every panel and the panel loop a ``fori_loop``."""
    levels = []
    d = 1
    while d < pr:
        down = tuple((s, (s - d) % pr) for s in range(pr))
        up = tuple((s, (s + d) % pr) for s in range(pr))
        levels.append((down, up, d))
        d *= 2
    return levels


def _strip_tree(strip, levels, tree, t_rot, pr, trans, prec):
    """Apply the row tree's couple reflectors to the representative strips:
    pair-exchange, SSRFB on the root side, send the bottom half back."""
    pairs = list(zip(levels, tree))
    for (down, up, d), (v2l, t2l) in pairs if trans else pairs[::-1]:
        recv = jax.lax.ppermute(strip, "rows", down)
        new_top, new_bot = ssrfb(v2l, t2l, strip, recv, trans, prec)
        back = jax.lax.ppermute(new_bot, "rows", up)
        root_side = (t_rot % (2 * d) == 0) & (t_rot + d < pr)
        leaf_side = t_rot % (2 * d) == d
        strip = jnp.where(root_side, new_top, jnp.where(leaf_side, back, strip))
    return strip


# Loop segments of the sharded drivers: one compiled panel body each (fewer
# than the one-device loop driver's, for the compile of the collectives),
# at about 1 + 3/(2·segments) times the update flops.
SEGMENTS = 4


def _seg_table(k_max: int, pr: int, pc: int, segments: int):
    """Loop segments [ks, ke) (square.loop_segments) with the local row and
    column tile where each device's part of the segment's trailing block
    starts: global tiles >= ks are local tiles >= ks // p everywhere."""
    return tuple((ks, ke, ks // pr, ks // pc) for ks, ke in loop_segments(k_max, segments))


def _local_row(k, r, pr: int, nb: int, lr: int):
    """Row of device row r's first tile at or below panel k's diagonal, in
    a block that starts at local tile row lr."""
    return (k // pr + (r < k % pr).astype(jnp.int32) - lr) * nb


def qr_sharded_factor(
    a: jnp.ndarray,
    mesh: Optional[Mesh] = None,
    config: Optional[QRConfig] = None,
    segments: int = SEGMENTS,
) -> ShardedQRFactors:
    """Factor A across a 2D device mesh. Returns distributed factors; use
    ``assemble_r_sharded`` for R and ``apply_q_sharded`` for Q products."""
    cfg = config if config is not None else QRConfig()
    nb = cfg.nb
    if mesh is None:
        mesh = make_mesh(cfg)
    pr, pc = mesh.devices.shape
    a = jnp.asarray(a, cfg.dtype)
    m, n = a.shape
    grid = (round_up(m, nb * pr) // nb, round_up(n, nb * pc) // nb, pr, pc)
    segs = _seg_table(min(grid[0], grid[1]), pr, pc, segments)
    local, r_diag, panels = _factor_jit(a, nb, grid, segs, cfg.precision, mesh)
    return ShardedQRFactors(local, r_diag, panels, nb, (m, n), grid, segs)


@functools.partial(
    jax.jit, static_argnames=("nb", "grid", "segs", "precision", "mesh")
)
def _factor_jit(a, nb, grid, segs, precision, mesh):
    mt, nt, pr, pc = grid
    prec = resolve_precision(precision)
    k_max = min(mt, nt)
    levels = _tree_levels(pr)
    m, n = a.shape
    a = jnp.pad(a, ((0, mt * nb - m), (0, nt * nb - n)))
    local = _to_local_layout(a, nb, pr, pc)
    # two dummy zero tile rows + columns per device: every device row keeps
    # at least one (zero) tile at or below each panel's diagonal
    local = jnp.pad(local, ((0, 0), (0, 0), (0, 2 * nb), (0, 2 * nb)))

    def body(loc):
        loc = loc[0, 0]
        dt = loc.dtype
        r = jax.lax.axis_index("rows")
        c = jax.lax.axis_index("cols")
        zero = jnp.zeros((k_max, nb, nb), dt)
        ztree = jnp.zeros((k_max, len(levels), nb, nb), dt)
        # r_diag, packed, tg, t2, tree V2, tree T2
        bufs = (zero, zero, zero, zero, ztree, ztree)
        v2s = []
        for ks, ke, lr, lc in segs:
            sub = loc[lr * nb :, lc * nb :]
            h, w = sub.shape

            def panel(k, carry, ks=ks, lr=lr, lc=lc, h=h, w=w):
                k = jnp.asarray(k, jnp.int32)
                sub, bufs, v2 = carry
                r_k, c_k = k % pr, k % pc
                o = _local_row(k, r, pr, nb, lr)
                t_rot = (r - r_k) % pr

                # 1. panel-column broadcast along 'cols' (masked psum)
                col = jax.lax.dynamic_slice(sub, ix(0, (k // pc - lc) * nb), (h, nb))
                col = jax.lax.psum(col * (c == c_k).astype(dt), "cols")

                # 2. local chain: GEQRT + one TSQRT couple below row o
                r_loc, packed, tg, v2k, t2 = panel_factor_at(col, o, nb, prec)

                # 3. TTQRT tree over mesh rows
                rcur, tree = r_loc, []
                for down, up, d in levels:
                    recv = jax.lax.ppermute(rcur, "rows", down)
                    rnew, v2l, t2l = ttqrt(rcur, recv, prec)
                    root_side = (t_rot % (2 * d) == 0) & (t_rot + d < pr)
                    rcur = jnp.where(root_side, triu(rnew), rcur)
                    tree.append((v2l, t2l))

                # the tree root (device row r_k) holds the diagonal R tile:
                # replicate it by a masked psum over both axes
                root = ((r == r_k) & (c == c_k)).astype(dt)
                r_kk = jax.lax.psum(rcur * root, ("rows", "cols"))

                # 4. local trailing update + 5. strip tree
                sub = panel_apply_at(packed, tg, v2k, t2, sub, o, True, prec)
                strip = jax.lax.dynamic_slice(sub, ix(o, 0), (nb, w))
                strip = _strip_tree(strip, levels, tree, t_rot, pr, True, prec)
                sub = jax.lax.dynamic_update_slice(sub, strip, ix(o, 0))

                new = [r_kk, packed, tg, t2]
                if tree:
                    new += [jnp.stack([v for v, _ in tree]), jnp.stack([t for _, t in tree])]
                bufs = tuple(stack_put(b, x, k) for b, x in zip(bufs, new)) + bufs[len(new):]
                return sub, bufs, stack_put(v2, v2k, k - ks)

            v2 = jnp.zeros((ke - ks, h - nb, nb), dt)
            sub, bufs, v2 = jax.lax.fori_loop(ks, ke, panel, (sub, bufs, v2))
            loc = jax.lax.dynamic_update_slice(loc, sub, ix(lr * nb, lc * nb))
            v2s.append(v2[None, None])
        r_diag = bufs[0]
        dev = tuple(b[None, None] for b in bufs[1:])
        return loc[None, None], r_diag, dev + (tuple(v2s),)

    sh = P("rows", "cols")
    return jax.shard_map(
        body, mesh=mesh, in_specs=(sh,), out_specs=(sh, P(), sh),
        check_vma=False,
    )(local)


def assemble_r_sharded(f, mesh: Optional[Mesh] = None):
    """Gather + unpack the sharded factors into the (M-orig, N-orig) R, as a
    device array computed under jit (hh or hr factors)."""
    mt, nt, pr, pc = f.grid
    if mesh is None:
        mesh = mesh_from_factors(f.local, pr, pc)
    return _assemble_r_jit(f.local, f.r_diag, f.nb, f.grid, f.shape, mesh)


def apply_q_sharded(
    f,
    c: jnp.ndarray,
    mesh: Optional[Mesh] = None,
    trans: bool = True,
    config: Optional[QRConfig] = None,
):
    """C ← Qᵀ C (trans) or Q C with the distributed factors — replays the
    factor phases (local chain + row tree) on C's row windows. c: (M, P)."""
    from tileqr.drivers.sharded_hr import ShardedHRFactors, apply_q_sharded_hr

    if isinstance(f, ShardedHRFactors):
        return apply_q_sharded_hr(f, c, mesh=mesh, trans=trans, config=config)
    cfg = config if config is not None else QRConfig(nb=f.nb)
    mt, nt, pr, pc = f.grid
    if mesh is None:
        mesh = mesh_from_factors(f.local, pr, pc)
    c = jnp.asarray(c, f.local.dtype)
    out = _apply_jit(f.panels, c, f.nb, f.grid, f.segs, trans, cfg.precision, mesh)
    return out[: c.shape[0], : c.shape[1]]


@functools.partial(
    jax.jit, static_argnames=("nb", "grid", "segs", "trans", "precision", "mesh")
)
def _apply_jit(panels, c, nb, grid, segs, trans, precision, mesh):
    mt, nt, pr, pc = grid
    prec = resolve_precision(precision)
    lmt = mt // pr
    levels = _tree_levels(pr)
    mc, p = c.shape
    ppad = round_up(max(p, 1), nb * pc)
    cp = jnp.pad(c, ((0, mt * nb - mc), (0, ppad - p)))
    cl = _to_local_layout(cp, nb, pr, pc)
    cl = jnp.pad(cl, ((0, 0), (0, 0), (0, 2 * nb), (0, 0)))
    lp = cl.shape[3]  # local column width (all columns take part)

    def body(cloc, panels):
        cloc = cloc[0, 0]
        packed, tg, t2, tree_v, tree_t, v2s = jax.tree.map(lambda x: x[0, 0], panels)
        r = jax.lax.axis_index("rows")
        order = range(len(segs)) if trans else reversed(range(len(segs)))
        for si in order:
            ks, ke, lr, _ = segs[si]

            def panel(i, sub, ks=ks, ke=ke, lr=lr, v2=v2s[si]):
                i = jnp.asarray(i, jnp.int32)
                k = ks + i if trans else ke - 1 - i
                o = _local_row(k, r, pr, nb, lr)
                t_rot = (r - k % pr) % pr
                tv, tt = stack_get(tree_v, k), stack_get(tree_t, k)
                tree = [(tv[lv], tt[lv]) for lv in range(len(levels))]
                factors = (stack_get(packed, k), stack_get(tg, k),
                           stack_get(v2, k - ks), stack_get(t2, k))
                if trans:
                    sub = panel_apply_at(*factors, sub, o, True, prec)
                strip = jax.lax.dynamic_slice(sub, ix(o, 0), (nb, lp))
                strip = _strip_tree(strip, levels, tree, t_rot, pr, trans, prec)
                sub = jax.lax.dynamic_update_slice(sub, strip, ix(o, 0))
                if not trans:
                    sub = panel_apply_at(*factors, sub, o, False, prec)
                return sub

            sub = jax.lax.fori_loop(0, ke - ks, panel, cloc[lr * nb :])
            cloc = jax.lax.dynamic_update_slice(cloc, sub, ix(lr * nb, 0))
        return cloc[None, None]

    sh = P("rows", "cols")
    cl_out = jax.shard_map(
        body, mesh=mesh, in_specs=(sh, sh), out_specs=sh, check_vma=False,
    )(cl, panels)
    return _unpack_local_jit(cl_out, nb, lmt, lp // nb, mesh)


def qr_sharded(
    a: jnp.ndarray,
    mesh: Optional[Mesh] = None,
    config: Optional[QRConfig] = None,
    mode: str = "r",
):
    """2D block-cyclic sharded QR (BASELINE.json:11 config).

    mode "r" → R (M, N); "factor" → ShardedQRFactors (hh) or
    ShardedHRFactors (square_method="hr").
    """
    shape = jnp.shape(a)
    if len(shape) != 2 or 0 in shape:
        raise ValueError(
            f"qr_sharded expects a 2-D matrix with no zero-size dimension, "
            f"got shape {shape}"
        )
    if mode not in ("r", "factor"):
        raise ValueError(f"unknown mode {mode!r}")
    cfg = config if config is not None else QRConfig()
    if cfg.square_method == "hr":
        # gram-panel CholeskyQR2 + Householder reconstruction (one psum per
        # phase, O(segments) program at any panel count; cond(A) ≲ 1e3
        # contract — drivers/sharded_hr.py)
        from tileqr.drivers.cholqr import guard_trips
        from tileqr.drivers.sharded_hr import qr_sharded_factor_hr

        fh = qr_sharded_factor_hr(a, mesh, cfg)
        # CholeskyQR breakdown guard (same monitor/policy as the single-
        # device hr path, QRConfig.hr_guard): on a tripped gate, fall
        # through to the unconditionally stable Householder driver below
        health = fh.health if cfg.hr_guard != "off" else None
        if not (
            guard_trips(health, cfg, "qr_sharded/hr")
            and cfg.hr_guard == "fallback"
        ):
            return fh if mode == "factor" else assemble_r_sharded(fh)
    f = qr_sharded_factor(a, mesh, cfg)
    return f if mode == "factor" else assemble_r_sharded(f)
