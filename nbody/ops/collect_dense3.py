"""Dense (window-stencil) 3D interaction-list collection.

The gather walk (``bh3d._collect_lists_3d``) pays one scattered row
gather per frontier lane per level — G x sum(frontier_caps) rows/step —
plus a per-level
[G, 8*cap] compaction sort.  This module replaces both with dense
spatial *windows*: measured reach (scripts/windows.py) shows the cells
a group's dual walk can touch at level ``l`` live in a box of <= ~32
cells around the group's own bbox (theta=0.5 reach bound: a reached
cell's parent fails theta, so it lies within 2*size_{l-1} of the bbox —
ceil(2/theta)+2 = 6 cells for a cubical domain, ~10 measured on
non-cubical blob bounds), so each group reads one contiguous
``[W, W, W]`` slab per level via ``dynamic_slice`` — no gathers, no
per-level sorts — and classifies every cell in it.  Reachability is
propagated *down* the pyramid by upsampling the parent window's open
flags (pure reshape/broadcast), replacing the frontier data structure
entirely.

Correctness is never windowed away: an opened cell whose children fall
outside the next level's window marks its group *escaped*; escaped
groups are re-collected exactly by the gather walk (a small ``spill``
pass under ``lax.cond``, skipped at runtime when no group escapes —
measured zero escapes on uniform states at 256K-1M with the default
schedule), and escapes beyond ``spill_cap`` surface as the ordinary
overflow flag (the same contract as frontier-cap overflow, feeding the
caller's adaptive retry).

The walk consumes a second, *spatially indexed* pyramid
(:func:`build_spatial_pyramid`): per level a row-major ``[D, D, D]``
grid (D = 2**level) holding mass, COM (pre-divided once at build
time), body count, and the *Morton body prefix* — the number of bodies
in Morton-earlier cells — so direct cells emit their (start, count)
body ranges without the ``leaf_cum`` gather.  The prefix is computed
top-down from sibling counts in Morton rank order: no gathers anywhere
in the build (one scatter-add + strided window reductions).

Reference parity: this replaces the per-thread pointer-chasing DFS of
``ComputeForces`` (project.cu:631-726); the reference has no analogue of
either walk — the stencil design is a data-parallel redesign of its
traversal, sized by the same
demand-calibration discipline as the frontier schedule (SURVEY §2.6).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import MASS_SKIP_THRESHOLD

_INT_MAX = jnp.iinfo(jnp.int32).max

# Per-level window widths (cells per axis), calibrated by
# scripts/windows.py on uniform + two-blob states at 256K/512K/1M
# (max_depth 7, theta 0.5, gs 2048): l4 reach <= 14 everywhere; the l5
# uniform hump tops out at 28 (Morton-boundary straddlers); blob deep
# tails need 24/32 at md-1/md.  Entries beyond the table repeat the
# last.  Constraints: even, and W[l] <= 2*W[l-1] (window nesting).
WINDOW_SCHEDULE_3D = (1, 2, 4, 8, 16, 28, 24, 32)


def window_schedule_3d(max_depth: int) -> Tuple[int, ...]:
    t = WINDOW_SCHEDULE_3D
    return tuple(
        min(1 << lv, t[min(lv, len(t) - 1)]) for lv in range(max_depth + 1)
    )


class SpatialPyramid(NamedTuple):
    """Row-major spatial octree levels (root first).

    ``grid[l]``: [D, D, D, 5] f32 — (mass, comx, comy, comz, count),
    COM pre-divided (singleton cells carry the exact body position,
    matching the gather walk's cnt==1 branch).
    ``start[l]``: [D, D, D] i32 — Morton body prefix of the cell (the
    index of its first body in the Morton-sorted source arrays).
    """

    grid: Tuple[jax.Array, ...]
    start: Tuple[jax.Array, ...]
    bounds: jax.Array  # [6]
    max_depth: int


def spatial_cell_coords_3d(
    positions: jax.Array, bounds: jax.Array, max_depth: int
) -> jax.Array:
    """Per-body leaf-cell (cx, cy, cz) [N, 3] i32 by the same recursive
    midpoint subdivision as tree3d.morton_codes_3d (bit-identical
    decisions — the spatial grid must agree with the Morton tree)."""
    x, y, z = positions[:, 0], positions[:, 1], positions[:, 2]
    x_lo = jnp.full_like(x, bounds[0])
    x_hi = jnp.full_like(x, bounds[1])
    y_lo = jnp.full_like(y, bounds[2])
    y_hi = jnp.full_like(y, bounds[3])
    z_lo = jnp.full_like(z, bounds[4])
    z_hi = jnp.full_like(z, bounds[5])
    cx = jnp.zeros(x.shape, jnp.int32)
    cy = jnp.zeros(x.shape, jnp.int32)
    cz = jnp.zeros(x.shape, jnp.int32)
    for _ in range(max_depth):
        mid_x = (x_lo + x_hi) * 0.5
        mid_y = (y_lo + y_hi) * 0.5
        mid_z = (z_lo + z_hi) * 0.5
        bx = (x >= mid_x).astype(jnp.int32)
        by = (y >= mid_y).astype(jnp.int32)
        bz = (z >= mid_z).astype(jnp.int32)
        x_lo = jnp.where(bx == 1, mid_x, x_lo)
        x_hi = jnp.where(bx == 1, x_hi, mid_x)
        y_lo = jnp.where(by == 1, mid_y, y_lo)
        y_hi = jnp.where(by == 1, y_hi, mid_y)
        z_lo = jnp.where(bz == 1, mid_z, z_lo)
        z_hi = jnp.where(bz == 1, z_hi, mid_z)
        cx = (cx << 1) | bx
        cy = (cy << 1) | by
        cz = (cz << 1) | bz
    return jnp.stack([cx, cy, cz], axis=1)


def build_spatial_pyramid(
    positions: jax.Array,
    masses: jax.Array,
    bounds: jax.Array,
    max_depth: int,
) -> SpatialPyramid:
    """One scatter-add + strided 2x2x2 window reductions; the Morton
    body prefix propagates root->leaf from sibling counts (Morton rank
    (bz<<2)|(by<<1)|bx, tree3d.morton_codes_3d packing)."""
    n = positions.shape[0]
    d = 1 << max_depth
    c = spatial_cell_coords_3d(positions, bounds, max_depth)
    idx = (c[:, 0] * d + c[:, 1]) * d + c[:, 2]
    x, y, z = positions[:, 0], positions[:, 1], positions[:, 2]
    ones = jnp.ones((n,), masses.dtype)
    packed = jnp.stack(
        [masses, masses * x, masses * y, masses * z, x, y, z, ones], axis=1
    )  # [N, 8]
    raw = jax.ops.segment_sum(packed, idx, num_segments=d * d * d)
    raws = [raw.reshape(d, d, d, 8)]
    for _ in range(max_depth):
        r = raws[-1]
        d2 = r.shape[0] // 2
        raws.append(
            r.reshape(d2, 2, d2, 2, d2, 2, 8).sum(axis=(1, 3, 5))
        )
    raws.reverse()  # root first

    grid = []
    for r in raws:
        m = r[..., 0]
        cnt = r[..., 7]
        safe = jnp.where(m > 0, m, 1.0)[..., None]
        com = jnp.where(
            (cnt == 1.0)[..., None], r[..., 4:7], r[..., 1:4] / safe
        )
        grid.append(
            jnp.concatenate(
                [m[..., None], com, cnt[..., None]], axis=-1
            )
        )

    # Morton body prefix, root -> leaf.  Child block position within
    # the parent: spatial offsets (ex, ey, ez); Morton rank there is
    # (ez<<2)|(ey<<1)|ex.  excl(e) = sum of counts of Morton-earlier
    # siblings; start_child = start_parent + excl.
    starts = [jnp.zeros((1, 1, 1), jnp.int32)]
    for lv in range(1, max_depth + 1):
        cnt = raws[lv][..., 7].astype(jnp.int32)
        dl = cnt.shape[0]
        d2 = dl // 2
        blk = cnt.reshape(d2, 2, d2, 2, d2, 2)
        s6 = jnp.zeros((d2, 2, d2, 2, d2, 2), jnp.int32)
        run = jnp.zeros((d2, d2, d2), jnp.int32)
        for rank in range(8):
            ez, ey, ex = (rank >> 2) & 1, (rank >> 1) & 1, rank & 1
            s6 = s6.at[:, ex, :, ey, :, ez].set(starts[lv - 1] + run)
            run = run + blk[:, ex, :, ey, :, ez]
        starts.append(s6.reshape(dl, dl, dl))
    return SpatialPyramid(
        grid=tuple(grid),
        start=tuple(starts),
        bounds=bounds,
        max_depth=max_depth,
    )


def _window_origins(bbox, bounds, schedule):
    """Per-group, per-level window origins [G, 3] i32: even-aligned,
    centered on the group bbox, clamped to the domain and to the parent
    window (nesting: parent open flags must cover origin//2 ..
    origin//2 + W/2 — requires W[l] <= 2*W[l-1])."""
    x0, x1, y0, y1, z0, z1 = bbox
    glo = jnp.stack([x0.min(1), y0.min(1), z0.min(1)], axis=1)  # [G, 3]
    ghi = jnp.stack([x1.max(1), y1.max(1), z1.max(1)], axis=1)
    lo = jnp.stack([bounds[0], bounds[2], bounds[4]])
    hi = jnp.stack([bounds[1], bounds[3], bounds[5]])
    ext = hi - lo
    origins = []
    prev = None
    for lv, w in enumerate(schedule):
        dl = 1 << lv
        cell = ext / dl
        c_lo = jnp.clip(
            jnp.floor((glo - lo) / cell).astype(jnp.int32), 0, dl - 1
        )
        c_hi = jnp.clip(
            jnp.floor((ghi - lo) / cell).astype(jnp.int32), 0, dl - 1
        )
        desired = (c_lo + c_hi + 1 - w) // 2
        desired = jnp.clip(desired, 0, dl - w)
        desired = (desired // 2) * 2
        if prev is not None:
            wp = schedule[lv - 1]
            desired = jnp.clip(desired, 2 * prev, 2 * (prev + wp) - w)
        origins.append(desired)
        prev = desired
    return origins


def _slice_window(arr, origin, w):
    """vmapped dynamic_slice of [W, W, W(, F)] windows at [G, 3] origins."""
    extra = arr.ndim - 3

    def one(o):
        starts = (o[0], o[1], o[2]) + (jnp.int32(0),) * extra
        return jax.lax.dynamic_slice(
            arr, starts, (w, w, w) + arr.shape[3:]
        )

    return jax.vmap(one)(origin)


def _slice_window_batched(arr, origin, w):
    """Per-group slice of per-group volumes: [G, Wp, Wp, Wp] sliced at
    [G, 3] origins -> [G, W, W, W]."""

    def one(a, o):
        return jax.lax.dynamic_slice(a, (o[0], o[1], o[2]), (w, w, w))

    return jax.vmap(one)(arr, origin)


def collect_lists_3d_dense(
    bbox,  # 6-tuple of [G, Q] arrays: x0, x1, y0, y1, z0, z1
    tree,  # Morton Octree — consumed only by the spill pass
    spyr: SpatialPyramid,
    *,
    theta: float,
    softening: float,
    frontier_caps: Tuple[int, ...],  # spill-pass walk caps
    list_cap: int,
    direct_cap: int,
    direct_cell_max: int,
    window_schedule: Tuple[int, ...] | None = None,
    spill_cap: int | None = None,
):
    """Drop-in dense replacement for ``bh3d._collect_lists_3d`` (same
    return contract: (lx, ly, lz, lm) [G, L], ranges [G, D, 2],
    overflow [G]).

    Classification is identical cell-for-cell (verified by the exact
    set-equality test, tests/test_collect_dense.py); only the traversal
    data structure differs: windows + reached-flag upsampling instead
    of gathered frontiers.
    """
    from .bh3d import _collect_lists_3d
    from .bh_grouped import _sort_compact
    from .tree3d import level_cell_size_3d

    x0, x1, y0, y1, z0, z1 = bbox
    g = x0.shape[0]
    f32 = x0.dtype
    md = spyr.max_depth
    sched = window_schedule or window_schedule_3d(md)
    if len(sched) != md + 1:
        raise ValueError(
            f"window_schedule needs {md + 1} levels, got {len(sched)}"
        )
    origins = _window_origins(bbox, spyr.bounds, sched)
    soft = jnp.asarray(softening, f32)

    app_x, app_y, app_z, app_m, app_mask = [], [], [], [], []
    dir_s, dir_c, dir_mask = [], [], []
    escape = jnp.zeros((g,), bool)
    prev_open = jnp.ones((g, 1, 1, 1), bool)  # root reached

    for lv in range(md + 1):
        w = sched[lv]
        p = w * w * w
        is_last = lv == md
        full = w == (1 << lv)
        o = origins[lv]

        def _level(prev_open, lv=lv, w=w, p=p, is_last=is_last,
                   full=full, o=o):
            # window reads: one slice per group (broadcast when the
            # window IS the level — levels <= 3 cost no per-group copy)
            if full:
                awin = jnp.broadcast_to(
                    spyr.grid[lv][None], (g,) + spyr.grid[lv].shape
                )
                swin = jnp.broadcast_to(
                    spyr.start[lv][None], (g,) + spyr.start[lv].shape
                )
            else:
                awin = _slice_window(spyr.grid[lv], o, w)
                swin = _slice_window(spyr.start[lv], o, w)

            aflat = awin.reshape(g, p, 5)
            m = aflat[:, :, 0]
            cx = aflat[:, :, 1]
            cy = aflat[:, :, 2]
            cz = aflat[:, :, 3]
            cnt = aflat[:, :, 4]
            start = swin.reshape(g, p)

            # reached = parent window's open flags, upsampled 2x per
            # axis.  Even origins make the child window's parent span
            # exactly the [o//2 - o_prev, +w//2) slab of the parent.
            if lv == 0:
                reached = jnp.ones((g, 1), bool)
            else:
                wh = w // 2
                r_off = (o // 2) - origins[lv - 1]
                par = _slice_window_batched(
                    prev_open.astype(jnp.int8), r_off, wh
                )  # [G, wh, wh, wh]
                up = (
                    jnp.broadcast_to(
                        par[:, :, None, :, None, :, None],
                        (g, wh, 2, wh, 2, wh, 2),
                    )
                    .reshape(g, w, w, w)
                    .astype(bool)
                )
                reached = up.reshape(g, p)

            # theta test against the Q sub-bboxes (gather-walk
            # semantics: box->COM distance, sqrt after the min —
            # bh3d.py:294-316)
            cxe = cx[:, None, :]
            cye = cy[:, None, :]
            cze = cz[:, None, :]
            dx = jnp.maximum(
                jnp.maximum(x0[:, :, None] - cxe, cxe - x1[:, :, None]),
                0.0,
            )
            dy = jnp.maximum(
                jnp.maximum(y0[:, :, None] - cye, cye - y1[:, :, None]),
                0.0,
            )
            dz = jnp.maximum(
                jnp.maximum(z0[:, :, None] - cze, cze - z1[:, :, None]),
                0.0,
            )
            d2all = dx * dx + dy * dy + dz * dz  # [G, Q, P]
            d_min = jnp.sqrt(jnp.min(d2all, axis=1)) + soft
            size = level_cell_size_3d(spyr.bounds, lv).astype(f32)
            theta_ok = size < theta * d_min

            one = jnp.asarray(1.0, f32)
            nonempty = reached & (cnt > 0) & (m > MASS_SKIP_THRESHOLD)
            single = nonempty & (cnt == one)
            multi = nonempty & (cnt > one)
            approx = single | (multi & (theta_ok | is_last))
            direct = (
                multi
                & ~theta_ok
                & (not is_last)
                & (cnt <= direct_cell_max)
            )

            outs = [
                cx, cy, cz,
                jnp.where(approx, m, 0.0),
                approx,
                jnp.where(direct, start, 0),
                jnp.where(direct, cnt.astype(jnp.int32), 0),
                direct,
            ]
            if is_last:
                return tuple(outs)

            open_ = multi & ~theta_ok & ~direct
            # exact escape check: children of opened cells must land
            # inside the NEXT window, else this group's dense lists are
            # incomplete -> spill (the open flag is dropped so the
            # dense outputs stay self-consistent for unspilled lanes)
            wn = sched[lv + 1]
            on = origins[lv + 1]  # [G, 3]
            ix = jnp.arange(w, dtype=jnp.int32)
            ax = (o[:, 0:1] + ix)[:, :, None, None]  # [G, w, 1, 1]
            ay = (o[:, 1:2] + ix)[:, None, :, None]
            az = (o[:, 2:3] + ix)[:, None, None, :]
            within = (
                (2 * ax >= on[:, 0, None, None, None])
                & (2 * ax + 1 <= on[:, 0, None, None, None] + wn - 1)
                & (2 * ay >= on[:, 1, None, None, None])
                & (2 * ay + 1 <= on[:, 1, None, None, None] + wn - 1)
                & (2 * az >= on[:, 2, None, None, None])
                & (2 * az + 1 <= on[:, 2, None, None, None] + wn - 1)
            ).reshape(g, p)
            esc_l = jnp.any(open_ & ~within, axis=1)
            return tuple(outs) + (
                esc_l, (open_ & within).reshape(g, w, w, w)
            )

        def _dead(prev_open, w=w, p=p, is_last=is_last):
            zf = jnp.zeros((g, p), f32)
            zi = jnp.zeros((g, p), jnp.int32)
            zb = jnp.zeros((g, p), bool)
            outs = [zf, zf, zf, zf, zb, zi, zi, zb]
            if is_last:
                return tuple(outs)
            return tuple(outs) + (
                jnp.zeros((g,), bool),
                jnp.zeros((g, w, w, w), bool),
            )

        # dead-level runtime skip (the gather walk's discipline,
        # bh3d.py:413-428): a frontier that died out — uniform dcm=128
        # states leave the deep window levels empty — skips its window
        # reads + theta math at runtime.  Static shapes unchanged.
        if (
            p >= 4096
            and lv > 0
            and os.environ.get("NBODY_DEAD_LEVEL_SKIP", "1") != "0"
        ):
            res = jax.lax.cond(
                jnp.any(prev_open), _level, _dead, prev_open
            )
        else:
            res = _level(prev_open)

        res = list(res)
        app_x.append(res.pop(0))
        app_y.append(res.pop(0))
        app_z.append(res.pop(0))
        app_m.append(res.pop(0))
        app_mask.append(res.pop(0))
        dir_s.append(res.pop(0))
        dir_c.append(res.pop(0))
        dir_mask.append(res.pop(0))
        if is_last:
            break
        escape = escape | res.pop(0)
        prev_open = res.pop(0)

    (lx, ly, lz, lm), ovf_a = _sort_compact(
        jnp.concatenate(app_mask, axis=1),
        [
            jnp.concatenate(app_x, axis=1),
            jnp.concatenate(app_y, axis=1),
            jnp.concatenate(app_z, axis=1),
            jnp.concatenate(app_m, axis=1),
        ],
        list_cap,
    )
    (ds, dc), ovf_d = _sort_compact(
        jnp.concatenate(dir_mask, axis=1),
        [jnp.concatenate(dir_s, axis=1), jnp.concatenate(dir_c, axis=1)],
        direct_cap,
    )
    overflow = ovf_a | ovf_d

    # ---- spill: exact gather-walk recollection of escaped groups ----
    if spill_cap is None:
        # measured escape censuses (CPU replay of the engine grouping,
        # round 5): 256K two-blob = 18 groups at gs=2048 and 17 at
        # gs=4096, 1M = 35 at gs=2048; uniform = 0 at every scale.
        # The escape COUNT is ~constant in G (blob geometry sets it,
        # not the group count — fatter groups have wider bboxes but
        # there are proportionally fewer of them), so the budget needs
        # an absolute floor: 48 ~= 2.7x the worst observed count
        # (a G//4-only budget was off by one at G=64: 16 < 17, and one
        # escaped group forced the 4x adaptive retry on every step).
        # The spill pass only executes under the any-escape cond, so
        # uniform states never pay it, and blob states pay
        # ~spill_cap/G of one gather collect instead of a full-step
        # adaptive retry.
        spill_cap = max(48, g // 4)
    spill_cap = min(spill_cap, g)
    esc_rank = jnp.cumsum(escape.astype(jnp.int32)) - 1
    overflow = overflow | (escape & (esc_rank >= spill_cap))

    n_out = [lx, ly, lz, lm, ds, dc]

    def _spill(args):
        outs, ovf = args
        key = jnp.where(
            escape, jnp.arange(g, dtype=jnp.int32), _INT_MAX
        )
        ids = jax.lax.sort(key)[:spill_cap]  # escaped group rows
        valid = ids != _INT_MAX
        safe_ids = jnp.where(valid, ids, 0)
        sb = tuple(b[safe_ids] for b in bbox)  # [S, Q] each
        # compact to the dense outputs' ACTUAL widths (at toy scales the
        # window lane budget can undercut list_cap/direct_cap); the
        # gather walk's own overflow flag then covers any truncation
        (slx, sly, slz, slm), sranges, sovf = _collect_lists_3d(
            sb,
            tree,
            theta=theta,
            softening=softening,
            frontier_caps=frontier_caps,
            list_cap=lx.shape[1],
            direct_cap=ds.shape[1],
            direct_cell_max=direct_cell_max,
        )
        srcs = [slx, sly, slz, slm, sranges[:, :, 0], sranges[:, :, 1]]
        # rows of invalid lanes scatter to index g -> dropped
        tgt = jnp.where(valid, ids, g)
        outs = [a.at[tgt].set(s) for a, s in zip(outs, srcs)]
        ovf = ovf.at[tgt].set(sovf)
        return outs, ovf

    if spill_cap > 0:
        n_out, overflow = jax.lax.cond(
            jnp.any(escape), _spill, lambda a: a, (n_out, overflow)
        )
    else:  # no spill budget: every escape is an overflow (set above)
        pass
    lx, ly, lz, lm, ds, dc = n_out
    ranges = jnp.stack([ds, dc], axis=-1)
    return (lx, ly, lz, lm), ranges, overflow
