"""Group-based Barnes-Hut in 3D: Morton-sorted groups over the octree.

The 3D generalisation the reference's report names (octree / ``N_DIM=3``,
project_report.pdf p.8) but never implements (the shipped code is 2D-only,
project.cu:28; ``plot_3d.py`` is non-functional).  Same design as the 2D
grouped engine (ops/bh_grouped.py):

1. sort bodies by 3D Morton code — consecutive bodies are spatially
   compact;
2. fixed-size groups with Q sub-bboxes (static shapes);
3. one conservative dual traversal per group over the dense octree
   pyramid: accept cell iff size_l / d_min < theta with d_min the
   group-bbox -> cell-COM distance lower bound (only ever opens MORE
   than per-body BH — at least as accurate);
4. close multi-body cells are emitted as Morton-contiguous body *ranges*
   (exact pairwise resolution via 8-body superblock gathers);
5. evaluation is dense bodies x list, chunked over groups, in XLA.

Self-exclusion is index-free: singleton cells and direct-range bodies
carry bit-exact positions, so a body meeting itself has d2 == 0 exactly
and the d2 > 0 guard drops it (see ops/tree3d.leaf_raw_3d).
"""

from __future__ import annotations

import functools
import os
from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import BH_SOFTENING, MASS_SKIP_THRESHOLD, THETA_DEFAULT
from .bh_grouped import (
    _SB,
    _expand_ranges_superblocks,
    _pow2_ceil,
    _sort_compact,
    evaluate_lists,
    superblock_pack,
)
from .tree3d import (
    R3_CNT,
    R3_M,
    R3_MX,
    R3_MY,
    R3_MZ,
    R3_OCC,
    R3_SX,
    R3_SY,
    R3_SZ,
    Octree,
    build_octree,
    default_max_depth3,
    level_cell_size_3d,
    morton_codes_3d,
)


def frontier_peak_3d(n_bodies: int) -> int:
    """3D cap scale: demand grows ~N^(2/3) (the surface of the opened
    region is 2D in a 3D domain, vs ~sqrt(N) in 2D).  Verified against
    measured per-group demand (gs=2048, theta=0.5, default depth):

    | N    | dist    | approx | direct cells | direct bodies | frontier |
    |------|---------|--------|--------------|---------------|----------|
    | 64K  | uniform | 1,470  | 2,782        | 39,601        | 2,356    |
    | 64K  | 2 blobs | 5,109  | 1,745        | 21,932        | 4,753    |
    | 256K | uniform | 4,201  | 7,923        | 100,021       | —        |
    | 256K | 2 blobs | 18,529 | 11,379       | 147,548       | —        |

    (ratios 64K->256K ~ 2.5-2.9 ~ 4^(2/3)); the overflow flag guards
    distributions that beat the headroom.  The 32K clamp engages at
    N ~ 1M (a 16K clamp left 5.3% of bodies overflowing there).

    The 4x multiplier (was 3x through round 4) exists for the md
    boundary band: at N in (92K, 143K] the default tree deepens to
    md=7 (``default_max_depth3`` crosses at 64K+1) while 3*N^(2/3)
    still rounded to the 64K-tier 8192, and a uniform 128K cloud
    persistently overflowed BOTH the frontier schedule and the list
    caps on one tail group — every contract step paid the 4x adaptive
    retry.  pow2_ceil absorbs 4x at every other scale (64K stays 8192,
    256K stays 16384, 512K/1M stay 32768); only the squeezed band
    moves to the 256K-tier caps, measured overflow-free there."""
    return min(32768, max(2048, _pow2_ceil(int(4 * n_bodies ** (2 / 3)))))


def direct_cell_max_default(n_bodies: int) -> int:
    """N-aware direct-cell threshold.  At 1M bodies the dcm=32 walk
    opens 33K-63K frontier cells per group at the deep levels (measured)
    and the frontier compaction sorts dominate the step; raising dcm
    stops the walk earlier — cells up to ``dcm`` bodies become exact
    Morton ranges instead of opening (7K/19K cells/group at dcm=128).
    Below 512K the extra direct volume cost more than the sorts saved.
    The 512K gate predates the GPU port and will be decided again on the
    card (ROADMAP Speed #4)."""
    return 32 if n_bodies < 524288 else 128


def default_group_size3(n_sources: int) -> int:
    """Morton group size for the 3D grouped engine (``group_size=None``).

    4096 in the [256K, 768K) band, 2048 elsewhere: halving the group count
    halves the per-group window/list work the dense collector pays, while
    per-group list demand stays nearly flat (theta + geometry set it, the
    observation that moved 512 -> 2048).  At 1M the dcm=128 regime's fat
    direct sections outgrow what the fewer, wider groups save.  The band
    predates the GPU port and will be decided again on the card (ROADMAP
    Speed #4)."""
    return 4096 if 262144 <= n_sources < 786432 else 2048


def cap_defaults_3d(n_bodies: int) -> dict:
    peak = frontier_peak_3d(n_bodies)
    dcm = direct_cell_max_default(n_bodies)
    if dcm >= 128:
        # The dcm=128 walk terminates far shallower than the dcm=32
        # calibration the peak-scaled caps were sized for: scripts/
        # demand.py measures approx <= 10,467 and direct cells <= 5,598
        # per group across 512K/1M x uniform/blobs on the initial states,
        # so 5/4*peak (40,960) and 3/4*peak (24,576) were many-x
        # oversized for the final compaction sorts.  The first step
        # needs more: unsoftened near-collision pairs fling bodies out of
        # the box, the root bbox grows and the cloud packs into fewer
        # top cells — 15,997 approx cells in the worst group after one
        # step of the seed-0 uniform 1M cloud (measured on the card).
        # 5/8*peak (20,480 at 1M) keeps 1.28x over that; peak//4 keeps
        # 1.46x over the direct cells; the overflow flag guards the rest.
        list_cap = max(4096, -(-(5 * peak // 8) // 2048) * 2048)
        direct_cap = max(2048, peak // 4)
    else:
        # 5/4*peak covers the collapsed-state approx hump (1.2x peak
        # measured), rounded up to a multiple of 2048
        list_cap = max(4096, -(-(5 * peak // 4) // 2048) * 2048)
        direct_cap = max(2048, 3 * peak // 4)
    return dict(
        list_cap=list_cap,
        direct_cap=direct_cap,
        # dcm=128 direct sections run to ~535K bodies/group at 1M
        # collapsed (measured); 20*peak = 655,360 there
        direct_body_cap=max(32768, (12 if dcm <= 32 else 20) * peak),
        frontier_cap=peak,
    )


def frontier_schedule_3d(
    peak: int, max_depth: int, n_bodies: int
) -> Tuple[int, ...]:
    """Per-level frontier capacities for the octree walk.

    Two regimes, both measured (overflow-free on uniform + two-blob
    collapsed states at every listed scale):

    * N < 512K (dcm=32): the 2D-style lstar hump model — demand peaks
      where bodies/cell ~ 16 and has a max-depth tail for collapsed
      states.
    * N >= 512K (dcm=128): the walk terminates where bodies/cell ~ dcm
      — l_t = ceil(log8(N/dcm)).  scripts/demand.py calibration
      (uniform + two-blob collapsed, fmul=2):

        1M uniform  [8, 64, 512, 1650, 8048, 0, 0, (md)]
        1M blobs    [8, 39, 108, 215, 965, 3672, 9608, (md)]
        512K uniform [8, 64, 512, 1650, 9160, 0, 0]
        512K blobs   [8, 31, 67, 267, 1139, 4216, 9960]

      The uniform spike enters l_t (and straddles l_t+1 when N/dcm is
      an exact power of 8 — 512K's l5 9,160 overflowed the round-3
      single-level ramp); collapsed states move the spike toward
      max_depth but SMALLER (dense matter occupies few cells).  Caps:
      3/8*peak at l_t and l_t+1 (1.3-1.5x measured), peak//4 on deeper
      non-terminal levels (1.9x+), peak//2 at max_depth (1.6x), peak//8
      above the zone (2.5x)."""
    import math

    hump = direct_cell_max_default(n_bodies) < 128
    # Every level from floor(l*) down gets the full peak: the hump can
    # only shift DEEPER mid-run (clustering / outlier-driven root-bbox
    # expansion raise the core's per-cell density — the 2D engine's
    # measured midsize-N failure, see bh_grouped.frontier_schedule).
    # The overflow flag and the run loop's per-step warning guard
    # pathological states in both regimes.
    lf = math.log(max(n_bodies, 128) / 16, 8)
    lo_star = min(max_depth, max(3, math.floor(lf)))
    dcm = direct_cell_max_default(n_bodies)
    l_t = min(
        max_depth, max(3, math.ceil(math.log(max(n_bodies // dcm, 8), 8)))
    )
    shape = []
    for level in range(max_depth + 1):
        if level <= 2:
            c = 8**level
        elif level == max_depth:
            c = peak if hump else peak // 2
        elif not hump:
            if level in (l_t, l_t + 1):
                c = 3 * peak // 8
            elif level > l_t + 1:
                c = peak // 4  # collapsed-state deep tail
            else:
                c = peak // 8
        elif level >= lo_star:
            c = peak
        else:
            c = peak >> min(lo_star - level, 3)
        shape.append(int(min(c, peak, 8**level)))
    return tuple(shape)


def _collect_lists_3d(
    bbox,  # 6-tuple of [G, Q] arrays: x0, x1, y0, y1, z0, z1
    tree: Octree,
    *,
    theta: float,
    softening: float,
    frontier_caps: Tuple[int, ...],
    list_cap: int,
    direct_cap: int,
    direct_cell_max: int,
    window_cells=None,
    return_demand: bool = False,
):
    """Per-group interaction lists via the dual cell-vs-bbox octree walk.

    Classification per frontier cell mirrors the 2D engine
    (ops/bh_grouped._collect_lists) with 8 children and 3-bit shifts:
    singletons and theta-ok / max-depth multis -> approx list; close
    small multis -> Morton body ranges; the rest open.

    Returns ((lx, ly, lz, lm) approx lists [G, L], ranges [G, D, 2],
    overflow [G] bool).  ``window_cells`` gates direct emission to the
    resident Morton window (sharded multi-chip mode — see the 2D
    mirror, ops/bh_grouped._collect_lists).

    ``return_demand=True`` appends a calibration dict (the measurements
    behind frontier_schedule_3d / cap_defaults_3d): ``frontier``
    [max_depth] max-over-groups opened-children demand entering each
    level, ``approx``/``direct`` max per-group totals — counted BEFORE
    truncation so demand above a cap stays visible, but only up to what
    the given caps let the walk reach (calibrate with generous caps;
    scripts/demand.py).
    """
    x0, x1, y0, y1, z0, z1 = bbox
    g = x0.shape[0]
    f32 = x0.dtype
    max_depth = tree.max_depth
    overflow = jnp.zeros((g,), bool)
    demand = []

    leaf_cnt = tree.leaf_counts()
    leaf_cum = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(leaf_cnt).astype(jnp.int32)]
    )  # [8^max_depth + 1]

    frontier = jnp.zeros((g, 1), jnp.int32)  # root
    fcap = 1

    app_x, app_y, app_z, app_m, app_mask = [], [], [], [], []
    dir_s, dir_c, dir_mask = [], [], []

    for level in range(max_depth + 1):
        is_last = level == max_depth
        fcap_l = fcap
        next_cap = (
            None if is_last else min(8 * fcap, frontier_caps[level + 1])
        )
        nf_width = (
            None
            if is_last
            else (8 * fcap if next_cap == 8 * fcap else next_cap)
        )

        def _level(frontier, level=level, is_last=is_last,
                   fcap_l=fcap_l, next_cap=next_cap):
            valid = frontier >= 0
            idx = jnp.where(valid, frontier, 0)
            rows = tree.raw[level][idx]  # [G, F, 16] — the one gather
            m = rows[..., R3_M]
            cnt = rows[..., R3_CNT]
            one = jnp.asarray(1.0, f32)
            safe = jnp.where(m > 0, m, one)
            cx = jnp.where(
                cnt == one, rows[..., R3_SX], rows[..., R3_MX] / safe
            )
            cy = jnp.where(
                cnt == one, rows[..., R3_SY], rows[..., R3_MY] / safe
            )
            cz = jnp.where(
                cnt == one, rows[..., R3_SZ], rows[..., R3_MZ] / safe
            )

            # distance from each sub-bbox to the cell COM (0 if inside)
            cxe, cye, cze = cx[:, None, :], cy[:, None, :], cz[:, None, :]
            dx = jnp.maximum(
                jnp.maximum(x0[:, :, None] - cxe, cxe - x1[:, :, None]),
                0.0,
            )  # [G, Q, F]
            dy = jnp.maximum(
                jnp.maximum(y0[:, :, None] - cye, cye - y1[:, :, None]),
                0.0,
            )
            dz = jnp.maximum(
                jnp.maximum(z0[:, :, None] - cze, cze - z1[:, :, None]),
                0.0,
            )
            d2all = dx * dx + dy * dy + dz * dz  # [G, Q, F]
            soft = jnp.asarray(softening, f32)
            # sqrt AFTER the min over sub-bboxes: bit-identical (sqrt is
            # monotone and correctly rounded per element) at 1/Q of the
            # sqrt volume — the [G, Q, F] tensors are the collect
            # phase's largest
            d_min = jnp.sqrt(jnp.min(d2all, axis=1)) + soft  # [G, F]
            size = level_cell_size_3d(tree.bounds, level).astype(f32)
            theta_ok = size < theta * d_min

            nonempty = valid & (cnt > 0) & (m > MASS_SKIP_THRESHOLD)
            single = nonempty & (cnt == one)
            multi = nonempty & (cnt > one)
            approx = single | (multi & (theta_ok | is_last))
            direct = (
                multi
                & ~theta_ok
                & (not is_last)
                & (cnt <= direct_cell_max)
            )
            if window_cells is not None:
                c_lo, c_hi = window_cells
                shift_w = 3 * (max_depth - level)
                in_win = ((idx << shift_w) >= c_lo) & (
                    ((idx + 1) << shift_w) <= c_hi + 1
                )
                direct = direct & in_win

            shift = 3 * (max_depth - level)
            outs = [
                cx, cy, cz,
                jnp.where(approx, m, 0.0),
                approx,
                idx << shift,
                jnp.where(direct, cnt.astype(jnp.int32), 0),
                direct,
            ]
            if is_last:
                return tuple(outs)

            open_ = multi & ~theta_ok & ~direct
            children = (
                idx[:, :, None] * 8 + jnp.arange(8, dtype=jnp.int32)
            ).reshape(g, -1)
            occ = rows[..., R3_OCC].astype(jnp.int32)
            child_bits = (
                (occ[:, :, None] >> jnp.arange(8, dtype=jnp.int32)) & 1
            ).reshape(g, -1)
            cmask = jnp.repeat(open_, 8, axis=1) & (child_bits > 0)

            if return_demand:
                outs.append(jnp.max(jnp.sum(cmask, axis=1)))

            if next_cap == 8 * fcap_l:
                # non-binding cap: skip the cosmetic compaction sort
                # (see the 2D mirror)
                nf = jnp.where(cmask, children, -1)
                ovf = jnp.zeros((g,), bool)
            else:
                (nf,), ovf = _sort_compact(
                    cmask, [jnp.where(cmask, children, -1)], next_cap
                )
            return tuple(outs) + (nf, ovf)

        def _dead(frontier, is_last=is_last, fcap_l=fcap_l,
                  nf_width=nf_width):
            zf = jnp.zeros((g, fcap_l), f32)
            zi = jnp.zeros((g, fcap_l), jnp.int32)
            zb = jnp.zeros((g, fcap_l), bool)
            outs = [zf, zf, zf, zf, zb, zi, zi, zb]
            if is_last:
                return tuple(outs)
            return tuple(outs) + (
                jnp.full((g, nf_width), -1, jnp.int32),
                jnp.zeros((g,), bool),
            )

        # a frontier that died out (uniform 256K: levels 6-7 carry 8 and
        # 0 cells against a 16,384 cap — the schedule's collapsed-state
        # tail) skips its gather + theta math at runtime; static shapes
        # and caps are unchanged, so the worst case still fits.
        # NBODY_DEAD_LEVEL_SKIP=0 (read at trace time) disables the
        # lax.cond wrapper for same-invocation A/B measurement.
        if (
            fcap_l >= 1024
            and not return_demand
            and os.environ.get("NBODY_DEAD_LEVEL_SKIP", "1") != "0"
        ):
            res = jax.lax.cond(
                jnp.any(frontier >= 0), _level, _dead, frontier
            )
        else:
            res = _level(frontier)

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
        if return_demand:
            demand.append(res.pop(0))
        frontier = res.pop(0)
        overflow = overflow | res.pop(0)
        fcap = next_cap

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
    (dleaf, dc), ovf_d = _sort_compact(
        jnp.concatenate(dir_mask, axis=1),
        [jnp.concatenate(dir_s, axis=1), jnp.concatenate(dir_c, axis=1)],
        direct_cap,
    )
    ds = jnp.where(dc > 0, leaf_cum[jnp.where(dc > 0, dleaf, 0)], 0)
    overflow = overflow | ovf_a | ovf_d

    ranges = jnp.stack([ds, dc], axis=-1)  # [G, D, 2]
    if return_demand:
        stats = dict(
            frontier=jnp.stack(demand),
            approx=jnp.max(
                jnp.sum(jnp.concatenate(app_mask, axis=1), axis=1)
            ),
            direct=jnp.max(
                jnp.sum(jnp.concatenate(dir_mask, axis=1), axis=1)
            ),
        )
        return (lx, ly, lz, lm), ranges, overflow, stats
    return (lx, ly, lz, lm), ranges, overflow


@functools.partial(
    jax.jit,
    static_argnames=(
        "g",
        "theta",
        "max_depth",
        "softening",
        "group_size",
        "frontier_cap",
        "list_cap",
        "direct_cap",
        "direct_cell_max",
        "direct_body_cap",
        "group_chunk",
        "return_diagnostics",
        "n_sub",
        "collect",
    ),
)
def bh3_accelerations_grouped(
    positions: jax.Array,  # [N, 3]
    masses: jax.Array,  # [N]
    *,
    g: float,
    theta: float = THETA_DEFAULT,
    max_depth: int | None = None,
    softening: float = BH_SOFTENING,
    group_size: int | None = None,
    frontier_cap: int | None = None,
    list_cap: int | None = None,
    direct_cap: int | None = None,
    direct_cell_max: int | None = None,
    direct_body_cap: int | None = None,
    group_chunk: int = 32,
    return_diagnostics: bool = False,
    n_sub: int | None = None,
    collect: str | None = None,
):
    """Grouped 3D Barnes-Hut accelerations [N, 3] (+ overflow [N]).

    ``None`` caps resolve from :func:`cap_defaults_3d`; ``max_depth``
    defaults from :func:`tree3d.default_max_depth3` (bodies/leaf ~ 1);
    ``group_size=None`` resolves from :func:`default_group_size3`.
    ``collect`` picks the list-collection traversal: ``"gather"`` (the
    frontier walk), ``"dense"`` (window-stencil, ops/collect_dense3.py)
    or ``None``/``"auto"`` (reads ``NBODY_COLLECT3``, then the N-gate:
    dense at N >= 256K, gather below)."""
    n = positions.shape[0]
    f32 = positions.dtype
    if max_depth is None:
        max_depth = default_max_depth3(n)
    if group_size is None:
        group_size = default_group_size3(n)

    tree = build_octree(positions, masses, max_depth=max_depth)
    spyr = None
    if _resolve_collect(collect, n) == "dense":
        from .collect_dense3 import build_spatial_pyramid

        spyr = build_spatial_pyramid(
            positions, masses, tree.bounds, max_depth
        )

    # sources in Morton order: ONE packed [N, 4] row gather
    src_order = jnp.argsort(tree.codes)
    packed = jnp.concatenate([positions, masses[:, None]], axis=1)
    psort = packed[src_order]
    sorted_srcs = (
        psort[:, 0],
        psort[:, 1],
        psort[:, 2],
        jnp.asarray(g, f32) * psort[:, 3],
    )
    return grouped_eval_3d(
        positions,
        tree,
        sorted_srcs=sorted_srcs,
        g=g,
        theta=theta,
        softening=softening,
        group_size=group_size,
        frontier_cap=frontier_cap,
        list_cap=list_cap,
        direct_cap=direct_cap,
        direct_cell_max=direct_cell_max,
        direct_body_cap=direct_body_cap,
        group_chunk=group_chunk,
        return_diagnostics=return_diagnostics,
        target_sorted=psort[:, 0:3],
        target_order=src_order,
        n_sub=n_sub,
        collect=collect,
        spyr=spyr,
    )


# Auto gate for the dense (window-stencil) collector.  Below the gate the
# gather walk won (small clouds' windows are full levels, so the extra
# spatial-pyramid build + window lanes outweigh the few gathered rows
# they delete); above it the window walk won.  The gate predates the GPU
# port and will be decided again on the card (ROADMAP Speed #4).
DENSE_COLLECT_MIN_N = 262144


def _resolve_collect(collect: str | None, n_sources: int) -> str:
    """``None`` -> NBODY_COLLECT3 env (trace-time) -> auto N-gate."""
    mode = collect or os.environ.get("NBODY_COLLECT3") or "auto"
    if mode == "auto":
        return "dense" if n_sources >= DENSE_COLLECT_MIN_N else "gather"
    if mode not in ("gather", "dense"):
        raise ValueError(
            f"collect must be gather|dense|auto, got {mode!r}"
        )
    return mode


def grouped_eval_3d(
    target_positions: jax.Array,  # [Nt, 3] bodies to accelerate
    tree: Octree,
    *,
    sorted_srcs,  # (x, y, z, g*m) [Ns] each, ALL sources in Morton order
    g: float,
    theta: float = THETA_DEFAULT,
    softening: float = BH_SOFTENING,
    group_size: int | None = None,
    frontier_cap: int | None = None,
    list_cap: int | None = None,
    direct_cap: int | None = None,
    direct_cell_max: int | None = None,
    direct_body_cap: int | None = None,
    group_chunk: int = 32,
    return_diagnostics: bool = False,
    target_sorted: jax.Array | None = None,
    target_order: jax.Array | None = None,
    n_sub: int | None = None,
    window_cells=None,
    range_offset=None,
    n_sources_hint: int | None = None,
    collect: str | None = None,
    spyr=None,
):
    """Grouped 3D evaluation of arbitrary targets against a prebuilt
    octree — the 3D mirror of ops/bh_grouped.grouped_eval (multi-card:
    each device passes its local shard as targets against the gathered
    global sources; self-exclusion stays index-free via d2 > 0).  The
    window/offset/hint trio enables the sharded-source mode (see the 2D
    docstring).  ``collect="dense"`` routes list collection through the
    window-stencil walk (ops/collect_dense3.py, requires ``spyr``);
    the sharded-source mode (``window_cells``) stays on the gather
    walk."""
    n = target_positions.shape[0]
    ns = sorted_srcs[0].shape[0]
    max_depth = tree.max_depth

    n_eff = n_sources_hint if n_sources_hint else ns
    defaults = cap_defaults_3d(n_eff)
    if group_size is None:
        group_size = default_group_size3(n_eff)
    if direct_cell_max is None:
        direct_cell_max = direct_cell_max_default(n_eff)
    frontier_cap = frontier_cap or defaults["frontier_cap"]
    list_cap = list_cap or defaults["list_cap"]
    direct_cap = direct_cap or defaults["direct_cap"]
    direct_body_cap = direct_body_cap or defaults["direct_body_cap"]

    sb_packed = superblock_pack(*sorted_srcs)

    if target_order is None:
        target_order = jnp.argsort(
            morton_codes_3d(target_positions, tree.bounds, max_depth)
        )
    gs = min(group_size, max(n, 1))
    n_pad = ((n + gs - 1) // gs) * gs
    tsort = (
        target_positions[target_order]
        if target_sorted is None
        else target_sorted
    )
    tsort = jnp.concatenate(
        [tsort, jnp.broadcast_to(tsort[-1], (n_pad - n, 3))], axis=0
    )
    pg = tsort.reshape(-1, gs, 3)  # [G, S, 3]

    if n_sub is None:
        n_sub = max(4, gs // 128)
    if gs % n_sub:
        n_sub = 1
    sub = pg.reshape(pg.shape[0], n_sub, gs // n_sub, 3)
    bbox = (
        jnp.min(sub[..., 0], axis=2),
        jnp.max(sub[..., 0], axis=2),
        jnp.min(sub[..., 1], axis=2),
        jnp.max(sub[..., 1], axis=2),
        jnp.min(sub[..., 2], axis=2),
        jnp.max(sub[..., 2], axis=2),
    )
    frontier_caps = frontier_schedule_3d(frontier_cap, max_depth, n_eff)
    use_dense = (
        _resolve_collect(collect, n_eff) == "dense"
        and spyr is not None
        and window_cells is None
    )
    if use_dense:
        from .collect_dense3 import collect_lists_3d_dense

        lists, ranges, overflow_g = collect_lists_3d_dense(
            bbox,
            tree,
            spyr,
            theta=theta,
            softening=softening,
            frontier_caps=frontier_caps,
            list_cap=list_cap,
            direct_cap=direct_cap,
            direct_cell_max=direct_cell_max,
        )
    else:
        lists, ranges, overflow_g = _collect_lists_3d(
            bbox,
            tree,
            theta=theta,
            softening=softening,
            frontier_caps=frontier_caps,
            list_cap=list_cap,
            direct_cap=direct_cap,
            direct_cell_max=direct_cell_max,
            window_cells=window_cells,
        )
    if range_offset is not None:
        ranges = ranges.at[:, :, 0].set(
            jnp.where(
                ranges[:, :, 1] > 0, ranges[:, :, 0] - range_offset, 0
            )
        )
    # NOTE: a merge_ranges + expand_runs_superblocks variant (now in
    # ops/experiments.py; interval-union of the per-cell ranges) was
    # measured end-to-end and LOST to the static per-cell expansion, with
    # run-cap overflow on 2 groups at 256K — the near-field cells that
    # fail to merge are numerous enough that run enumeration costs more
    # than the boundary-superblock slack it removes.
    sb_cap = direct_body_cap // _SB + direct_cap
    sb_idx, sb_lo, sb_hi, ovf_b = _expand_ranges_superblocks(
        ranges, direct_cell_max, sb_cap
    )
    overflow_g = overflow_g | ovf_b
    ax, ay, az = evaluate_lists(
        pg,
        lists,
        (sb_idx, sb_lo, sb_hi),
        sb_packed,
        g_const=g,
        softening=softening,
        group_chunk=group_chunk,
    )

    # un-sort by sorting on the permutation (see ops/bh_grouped.py)
    axs = ax.reshape(-1)[:n]
    ays = ay.reshape(-1)[:n]
    azs = az.reshape(-1)[:n]
    if return_diagnostics:
        ovf_sorted = jnp.repeat(overflow_g, gs)[:n]
        _, ax_o, ay_o, az_o, ovf = jax.lax.sort(
            [target_order, axs, ays, azs, ovf_sorted.astype(jnp.int32)],
            dimension=0, num_keys=1, is_stable=False,
        )
        return (
            jnp.stack([ax_o, ay_o, az_o], axis=-1),
            ovf.astype(bool),
        )
    _, ax_o, ay_o, az_o = jax.lax.sort(
        [target_order, axs, ays, azs],
        dimension=0, num_keys=1, is_stable=False,
    )
    return jnp.stack([ax_o, ay_o, az_o], axis=-1)
