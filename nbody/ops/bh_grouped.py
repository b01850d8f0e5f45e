"""Group-based Barnes-Hut: Morton-sorted body groups share one traversal.

The per-body frontier traversal (barnes_hut.py) is semantically exact but
gather-bound: [N, frontier] gathers per level dominate the step.  This
module is the standard vectorised tree-code design (cf. the SIMD/GPU
tree-method literature in PAPERS.md — patterns only):

1. sort bodies by Morton code (jax.lax.sort_key_val) so consecutive
   bodies are spatially compact;
2. cut the sorted order into fixed-size groups (static shapes); per group
   compute the bounding box of its members;
3. traverse the pyramid ONCE per group with a conservative acceptance
   test: accept cell c iff  size_l / d_min < theta  where d_min is the
   distance from the group's bbox to the cell COM.  Every member body has
   d >= d_min, so each member's own theta test also passes — the group
   decision only ever *opens more* than the reference's per-body DFS
   (project.cu:641-643), i.e. it is at least as accurate;
4. accepted cells and terminal cells (singletons, max-depth aggregates)
   are compacted into a per-group interaction list of (x, y, mass);
5. evaluation is dense and regular: group bodies x interaction list, the
   same pattern as the all-pairs kernel.  Gather volume drops by the
   group size and all heavy compute is vectorised.

Self-interaction: singleton cells carry bit-exact body positions (see
tree.leaf_aggregates), so a body meeting its own singleton cell has
d2 == 0 exactly and the d2 > 0 guard excludes it — no occupant-index
bookkeeping.  Max-depth multi-body cells are included even for their own
members, preserving the reference's aggregate-self-pull quirk
(project.cu:378/760).

group_size=1 makes the bbox a point, d_min the exact body-COM distance,
and the acceptance identical to the reference traversal.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import (
    BH_SOFTENING,
    MASS_SKIP_THRESHOLD,
    MAX_DEPTH_DEFAULT,
    THETA_DEFAULT,
)
from .tree import (
    RAW_CNT,
    RAW_M,
    RAW_MX,
    RAW_MY,
    RAW_OCC,
    RAW_SX,
    RAW_SY,
    Quadtree,
    build_quadtree,
    level_cell_size,
    morton_codes,
)


_INT_MAX = jnp.int32(2**31 - 1)


def _pow2_ceil(x: int) -> int:
    return 1 << max(x - 1, 1).bit_length()


def frontier_peak(n_bodies: int) -> int:
    """Measured peak frontier demand grows ~4*sqrt(N) (gs=2048, n_sub=16,
    theta=0.5): 722 @64K, 1452 @256K, 2646 @1M.  Next power of two with
    ~1.5x headroom, clamped to [1024, 8192]."""
    return min(8192, max(1024, _pow2_ceil(int(4 * n_bodies**0.5))))


# 2D default Morton group size (``group_size=None``).  2048 at every N:
# the round-2 A/B moved 512 -> 2048 (fewer groups = proportionally fewer
# per-level gathers, accuracy IMPROVES — conservative opening only ever
# opens more); a 4096 probe is only measured in 3D where it wins in the
# [256K, 768K) band (bh3d.default_group_size3) — 2D headline scales
# (40,960-64K) would drop to 10-16 groups and starve the group_chunk
# pipeline.
DEFAULT_GROUP_SIZE = 2048


def cap_defaults(group_size: int, n_bodies: int) -> dict:
    """Interaction-list cap defaults, calibrated on measured per-group
    demand (scripts/demand.py; uniform + two-blob collapsed
    distributions, gs=2048, n_sub=16):

    | N    | approx (uni/blob) | direct cells | frontier (uni/blob) |
    |------|-------------------|--------------|----------------------|
    | 64K  | 398 / 566         | 517 / 2,018  | 722 / 1,468          |
    | 256K | 1,062             | 1,073        | 1,452                |
    | 1M   | 1,818 / 5,750     | 1,743 / 933  | 2,646 / 5,104        |

    The collapsed state dominates approx demand at large N (deep
    aggregates) and direct demand at small N (dense near fields at
    coarse leaf resolution); the round-2 uniform-only calibration
    overflowed on blobs at 64K (direct) and 1M (approx + frontier
    max-depth tail) — caught by the round-3 calibration tooling.  The
    overflow flag guards any distribution beyond the headroom.
    """
    peak = frontier_peak(n_bodies)
    return dict(
        # 7/4*peak (rounded up to a multiple of 2048) covers the
        # 1M-blobs 5,750 with 1.42x headroom
        list_cap=max(2048, -(-(7 * peak // 4) // 2048) * 2048),
        # floor 2,560 covers the 64K-blobs 2,018 (1.27x); 3/4*peak
        # keeps the uniform large-N scaling (1.76x at 1M); a direct
        # cell holds >= 2 bodies, so n//2 bounds the count at small N
        # (keeps small-N compiles narrow)
        direct_cap=min(
            max(2560, 3 * peak // 4), max(256, n_bodies // 2)
        ),
        direct_body_cap=max(24576, 16 * peak),
        frontier_cap=peak,
    )


def frontier_schedule(
    peak: int, max_depth: int, n_bodies: int
) -> Tuple[int, ...]:
    """Per-level frontier capacities.

    A flat cap pays the peak at EVERY level; the measured demand is a
    hump peaking at the level where bodies/cell ~ 16 (uniform states;
    e.g. level 6 at N=64K, level 8 at N=1M) with a secondary tail at
    max_depth for collapsed states (measured up to 2*peak: 1,468 @64K /
    5,104 @1M two-blob).  The schedule sizes the peak level at ``peak``,
    its neighbours at peak/2..peak/8 by distance, and the deepest TWO
    levels at ``2*peak`` (the collapsed tail peaks at max_depth-1 or
    max_depth depending on N), cutting total gather rows ~3x vs a flat
    2*peak cap at N=64K; the overflow flag still guards any
    distribution that beats it.

    The hump level l* = log4(N/16) holds for a uniform cloud filling the
    root bbox; it is NOT stable mid-run.  Two measured failure modes
    (round 3, N=24,576): (a) fractional l* — demand straddles floor(l*)
    and ceil(l*), and a round()-picked single peak level overflowed at
    step 0; (b) after one unsoftened close encounter ejects outliers,
    the root bbox expands and the core's per-cell density rises, shifting
    the hump DEEPER by log2(bbox growth) — level-7/8 demand then beat
    peak/2 at step 1.  Clustering and bbox expansion can only ever move
    the hump deeper (the initial uniform state is the density minimum),
    so every level from floor(l*) down to max_depth gets the full peak;
    levels above the hump keep the pruned ramp (their demand is bounded
    by cell count and geometry, not density).
    """
    import math

    lf = math.log(max(n_bodies, 256) / 16, 4)
    lo_star = min(max_depth, max(4, math.floor(lf)))
    shape = []
    for level in range(max_depth + 1):
        if level <= 3:
            c = 4**level
        elif level >= max_depth - 1:
            # collapsed-state tail peaks at max_depth-1 or max_depth
            # (scripts/demand.py blobs: 1,468 @l8/md=9 at 64K, 5,104
            # @l9=md at 1M — both above the old flat peak)
            c = 2 * peak
        elif level >= lo_star:
            c = peak
        else:
            c = peak >> min(lo_star - level, 3)
        shape.append(int(min(c, 2 * peak, 4**level)))
    return tuple(shape)


def _sort_compact(mask, arrays, cap):
    """Compact masked row entries to the left and truncate to ``cap``.

    Scatter-free: one sort on a column key compacts every payload at once.
    Entries keep their left-to-right order (key = column index for valid,
    INT_MAX for invalid).

    Returns (compacted arrays [G, cap], overflow [G] bool).
    """
    g, f = mask.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (g, f), 1)
    key = jnp.where(mask, col, _INT_MAX)
    sorted_ = jax.lax.sort(
        [key] + list(arrays), dimension=1, num_keys=1, is_stable=False
    )
    out = [a[:, :cap] for a in sorted_[1:]]
    overflow = jnp.sum(mask, axis=1) > cap
    return out, overflow


def _collect_lists(
    bbox: Tuple[jax.Array, jax.Array, jax.Array, jax.Array],  # [G, Q] each
    tree: Quadtree,
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
    """Per-group interaction lists via a dual (cell-vs-group-bbox) walk.

    Classification per frontier cell (conservative d_min from the group
    bbox to the cell COM; every member body's own theta test is implied):

    * count==1                        -> approx list (exact point mass)
    * theta-ok, count>=2              -> approx list (COM aggregate)
    * level==max_depth, count>=2      -> approx list (the reference's
      max-depth aggregated pseudo-body, project.cu:358-382 — own members
      included, preserving the aggregate-self-pull quirk)
    * not theta-ok, 2<=count<=direct_cell_max -> direct list as a body
      *range*: Morton sorting makes every cell a contiguous slice of the
      sorted body array, so close-range cells are resolved exactly by
      pairwise interaction instead of opening them to singleton depth
      (this is what bounds the frontier: without it, every cell inside
      the group's own bbox would be opened all the way down)
    * otherwise                       -> open (children to next frontier)

    Returns (cells [G, L, 3] (x, y, mass) zero-mass padded,
             ranges [G, D, 2] (start, count) zero-count padded,
             overflow [G] bool).

    ``window_cells=(c_lo, c_hi)`` (traced leaf-cell scalars) restricts
    direct emission to cells whose leaf span lies inside
    [c_lo, c_hi] — the sharded multi-chip mode's locally-resident
    source window.  Out-of-window close cells keep OPENING instead and
    terminate as singleton cells / max-depth aggregates, which need only
    the replicated pyramid — exactly the reference DFS's own treatment
    of every close cell (it never does pairwise-beyond-singletons), so
    physics stays within the reference approximation class while no
    chip ever touches a non-resident body.
    """
    # Sub-bboxes: each group carries Q bounding boxes (quarters of its
    # Morton run).  d_min = min over sub-boxes is a tighter-but-still-valid
    # lower bound on any member's distance; critically, a group whose run
    # straddles a Morton seam (e.g. the domain centre) has a huge union
    # bbox but tight quarters, so it no longer opens half the tree.
    x0, x1, y0, y1 = bbox  # [G, Q]
    g = x0.shape[0]
    f32 = x0.dtype
    max_depth = tree.max_depth
    overflow = jnp.zeros((g,), bool)
    demand = []  # return_demand: per-level pre-truncation calibration
    #              measurements (see the 3D mirror's docstring)

    # Per-cell packed rows come straight from the tree build
    # (Quadtree.raw, cols per tree.RAW_*): the traversal gathers whole raw
    # rows once per level and derives COM (division) and the
    # child-occupancy prune bits from the gathered [G, F, 8] array — no
    # per-level re-packing and no second gather into the child level.

    # per-cell body ranges in the Morton-sorted order: cumulative counts
    # over the finest level give [start, end) for any cell at any level
    leaf_cnt = tree.levels[max_depth].count
    leaf_cum = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(leaf_cnt).astype(jnp.int32)]
    )  # [4^max_depth + 1]

    frontier = jnp.zeros((g, 1), jnp.int32)  # root
    fcap = 1

    # per-level emitted candidates, concatenated and compacted ONCE at the
    # end (one sort instead of per-level scatters)
    app_x, app_y, app_m, app_mask = [], [], [], []
    dir_s, dir_c, dir_mask = [], [], []

    for level in range(max_depth + 1):
        valid = frontier >= 0
        idx = jnp.where(valid, frontier, 0)
        rows = tree.raw[level][idx]  # [G, F, 8] — the one gather
        m = rows[..., RAW_M]
        cnt = rows[..., RAW_CNT]
        one = jnp.asarray(1.0, f32)
        # COM derived post-gather (cheap: [G, F] not [4^l]); singleton
        # cells take the exact position sum (see tree.leaf_raw)
        safe = jnp.where(m > 0, m, one)
        cx = jnp.where(
            cnt == one, rows[..., RAW_SX], rows[..., RAW_MX] / safe
        )
        cy = jnp.where(
            cnt == one, rows[..., RAW_SY], rows[..., RAW_MY] / safe
        )

        # distance from each sub-bbox to the cell COM (0 if inside); the
        # binding bound is the minimum over sub-boxes
        cxe = cx[:, None, :]  # [G, 1, F]
        cye = cy[:, None, :]
        dx = jnp.maximum(
            jnp.maximum(x0[:, :, None] - cxe, cxe - x1[:, :, None]), 0.0
        )  # [G, Q, F]
        dy = jnp.maximum(
            jnp.maximum(y0[:, :, None] - cye, cye - y1[:, :, None]), 0.0
        )
        d2all = dx * dx + dy * dy  # [G, Q, F]
        soft = jnp.asarray(softening, f32)
        # sqrt AFTER the min over sub-bboxes: bit-identical (sqrt is
        # monotone, correctly rounded) at 1/Q of the sqrt volume
        d_min = jnp.sqrt(jnp.min(d2all, axis=1)) + soft  # [G, F]
        size = level_cell_size(tree.bounds, level).astype(f32)
        theta_ok = size < theta * d_min

        nonempty = valid & (cnt > 0) & (m > MASS_SKIP_THRESHOLD)
        single = nonempty & (cnt == one)
        multi = nonempty & (cnt > one)
        approx = single | (multi & (theta_ok | (level == max_depth)))
        direct = (
            multi
            & ~theta_ok
            & (level != max_depth)
            & (cnt <= direct_cell_max)
        )
        if window_cells is not None:
            # pure int math on the frontier (no gathers): a cell at this
            # level spans leaf cells [idx << s, (idx + 1) << s)
            c_lo, c_hi = window_cells
            shift_w = 2 * (max_depth - level)
            in_win = ((idx << shift_w) >= c_lo) & (
                ((idx + 1) << shift_w) <= c_hi + 1
            )
            direct = direct & in_win

        app_x.append(cx)
        app_y.append(cy)
        app_m.append(jnp.where(approx, m, 0.0))
        app_mask.append(approx)

        # direct cells are carried as their first-leaf-cell index
        # (c << 2*(max_depth-level), pure int math — the leaf_cum lookup
        # happens once on the compacted list, not per frontier entry)
        shift = 2 * (max_depth - level)
        dir_s.append(idx << shift)
        dir_c.append(jnp.where(direct, cnt.astype(jnp.int32), 0))
        dir_mask.append(direct)
        if level == max_depth:
            break

        open_ = multi & ~theta_ok & ~direct
        children = (
            idx[:, :, None] * 4 + jnp.arange(4, dtype=jnp.int32)
        ).reshape(g, -1)
        # children pruned by the occupancy bits delivered in the parent's
        # own raw row — no extra gather
        occ = rows[..., RAW_OCC].astype(jnp.int32)
        child_bits = (
            (occ[:, :, None] >> jnp.arange(4, dtype=jnp.int32)) & 1
        ).reshape(g, -1)
        cmask = jnp.repeat(open_, 4, axis=1) & (child_bits > 0)

        if return_demand:
            demand.append(jnp.max(jnp.sum(cmask, axis=1)))

        next_cap = min(4 * fcap, frontier_caps[level + 1])
        if next_cap == 4 * fcap:
            # the cap doesn't bind: no truncation is possible, so the
            # compaction sort is pure cosmetics — carry the children
            # with -1 holes instead (the walk masks on frontier >= 0)
            frontier = jnp.where(cmask, children, -1)
        else:
            (nf,), ovf = _sort_compact(
                cmask, [jnp.where(cmask, children, -1)], next_cap
            )
            overflow = overflow | ovf
            frontier = nf
        fcap = next_cap

    (lx, ly, lm), ovf_a = _sort_compact(
        jnp.concatenate(app_mask, axis=1),
        [
            jnp.concatenate(app_x, axis=1),
            jnp.concatenate(app_y, axis=1),
            jnp.concatenate(app_m, axis=1),
        ],
        list_cap,
    )
    (dleaf, dc), ovf_d = _sort_compact(
        jnp.concatenate(dir_mask, axis=1),
        [jnp.concatenate(dir_s, axis=1), jnp.concatenate(dir_c, axis=1)],
        direct_cap,
    )
    # one gather on the compacted list resolves leaf cell -> body range
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
        return (lx, ly, lm), ranges, overflow, stats
    return (lx, ly, lm), ranges, overflow


_SB = 8  # bodies per superblock (one packed gather row)


def _expand_ranges_superblocks(
    ranges: jax.Array,  # [G, D, 2] (start, count)
    direct_cell_max: int,
    sb_cap: int,
):
    """Expand direct cell ranges to a compact per-group *superblock* list.

    Direct sources are gathered eight bodies at a time: one packed 24-wide
    row per 8 bodies cuts the number of gathered rows ~8x.
    Each range [start, start+count) covers at most
    ceil((count + SB - 1) / SB) + 1 superblocks.

    Returns (sb_idx [G, C], lane lo [G, C], lane hi [G, C], overflow [G]);
    invalid entries have sb_idx == -1.  Per-lane masking against
    [lo, hi) happens in the evaluator (superblocks may contain bodies
    outside the range; ranges are disjoint so nothing double-counts).
    """
    g, d, _ = ranges.shape
    t_sb = (direct_cell_max + 2 * (_SB - 1)) // _SB + 1
    starts = ranges[:, :, 0]
    counts = ranges[:, :, 1]
    ends = starts + counts
    first = starts >> 3
    last = (ends - 1) >> 3  # arithmetic shift: count==0 -> last < first
    offs = jnp.arange(t_sb, dtype=jnp.int32)
    sb = (first[:, :, None] + offs).reshape(g, d * t_sb)
    mask = (offs[None, None, :] <= (last - first)[:, :, None]).reshape(
        g, d * t_sb
    )
    lo = jnp.broadcast_to(starts[:, :, None], (g, d, t_sb)).reshape(g, -1)
    hi = jnp.broadcast_to(ends[:, :, None], (g, d, t_sb)).reshape(g, -1)
    (sb_c, lo_c, hi_c), overflow = _sort_compact(
        mask,
        [jnp.where(mask, sb, -1), lo, jnp.where(mask, hi, 0)],
        sb_cap,
    )
    return sb_c, lo_c, hi_c, overflow


def _sum_last(*terms):
    """Sums over the last axis of several same-shape terms in ONE variadic
    reduction, so XLA can emit a single fused kernel over the shared
    pairwise producers instead of one pass per axis."""
    return jax.lax.reduce(
        terms,
        tuple(jnp.zeros((), t.dtype) for t in terms),
        lambda a, b: tuple(x + y for x, y in zip(a, b)),
        (terms[0].ndim - 1,),
    )


# Pairs one evaluation step holds: bounds the [groups, S, K] temporaries
# XLA may materialise to 2^26 f32 elements (256 MiB) whatever N, the group
# size and the list caps are.  Without it the padded 3D 1M direct list
# (direct_body_cap = 655,360 lanes) made one [32, 2048, ~720K] array of
# 177 GiB.
EVAL_PAIR_BUDGET = 1 << 26


def superblock_pack(*cols: jax.Array) -> jax.Array:
    """Pack Morton-sorted source columns (coordinates, then g*m) eight
    bodies per row: ``[Nsb, len(cols) * 8]``, one gathered row per eight
    direct bodies; the padding bodies have zero weight."""
    ns = cols[0].shape[0]
    pad = (-ns) % _SB
    return jnp.concatenate(
        [
            (jnp.pad(c, (0, pad)) if pad else c).reshape(-1, _SB)
            for c in cols
        ],
        axis=1,
    )


def _live_length(valid: jax.Array) -> jax.Array:
    """One past the last True along the last axis, over all rows (0 if
    none): the list prefix that can contribute."""
    idx = jnp.arange(1, valid.shape[-1] + 1, dtype=jnp.int32)
    return jnp.max(jnp.where(valid, idx, 0))


def _pad_last(a: jax.Array, multiple: int, value) -> jax.Array:
    pad = (-a.shape[-1]) % multiple
    if not pad:
        return a
    widths = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
    return jnp.pad(a, widths, constant_values=value)


def evaluate_lists(
    positions_grouped: jax.Array,  # [G, S, D] group member positions
    approx,  # (x, y[, z], m) [G, L] each: accepted cells, m = 0 unused
    direct_sb,  # (sb_idx [G, B], lo [G, B], hi [G, B]) superblock list
    sb_packed: jax.Array,  # [Nsb, (D+1)*8] from superblock_pack
    *,
    g_const: float,
    softening: float,
    group_chunk: int,
):
    """Bodies x (approx cells + direct superblocks) in XLA, in any
    dimension: ``group_chunk`` groups at a time, and within those the
    lists in blocks of at most ``EVAL_PAIR_BUDGET`` pairs.  Only the
    blocks up to the chunk's last live list entry run (a loop with a
    traced trip count), so the padding of the list caps costs no pairs.

    Direct sources are raw sorted body values (bit-exact), so a member
    body meeting itself is excluded by the d2 > 0 guard, exactly like the
    all-pairs kernel.  Superblock lanes outside the emitting range's
    [lo, hi) are masked (the superblock may span range boundaries).
    Returns the D acceleration components, each [G, S].
    """
    dims = positions_grouped.shape[-1]
    f32 = positions_grouped.dtype
    eps = jnp.asarray(softening, f32)
    n_groups, s = positions_grouped.shape[:2]
    chunk = min(group_chunk, n_groups)
    # list entries per block: the pair budget, or the whole list if shorter
    budget = max(_SB, (EVAL_PAIR_BUDGET // (chunk * s)) // _SB * _SB)
    lanes = min(budget, -(-approx[0].shape[1] // _SB) * _SB)
    sb_block = min(budget // _SB, direct_sb[0].shape[1])

    approx = (*approx[:-1], jnp.asarray(g_const, f32) * approx[-1])
    approx = tuple(_pad_last(a, lanes, 0.0) for a in approx)
    sb_idx, lo, hi = (
        _pad_last(a, sb_block, v) for a, v in zip(direct_sb, (-1, 0, 0))
    )
    gpad = (-n_groups) % chunk
    if gpad:
        positions_grouped = jnp.pad(
            positions_grouped, ((0, gpad), (0, 0), (0, 0))
        )
        approx = tuple(jnp.pad(a, ((0, gpad), (0, 0))) for a in approx)
        sb_idx, lo, hi = (
            jnp.pad(a, ((0, gpad), (0, 0)), constant_values=v)
            for a, v in zip((sb_idx, lo, hi), (-1, 0, 0))
        )
    lane = jnp.arange(_SB, dtype=jnp.int32)

    def pair_sums(bodies, src, sw):
        # bodies [C, S, 1] each; src / sw [C, 1, K]: sources, g*m weights
        disp = [sx - bx for sx, bx in zip(src, bodies)]  # [C, S, K]
        d2 = disp[0] * disp[0]
        for dd in disp[1:]:
            d2 = d2 + dd * dd
        valid = (d2 > 0.0) & (sw > 0.0)
        d = jnp.sqrt(d2) + eps
        w = jnp.where(valid, sw / (jnp.where(valid, d2, 1.0) * d), 0.0)
        return _sum_last(*(w * dd for dd in disp))

    def blocked(acc, n_live, block, partial_fn):
        def body(b, acc):
            return tuple(
                a + v for a, v in zip(acc, partial_fn(b * block))
            )

        return jax.lax.fori_loop(0, (n_live + block - 1) // block, body, acc)

    def chunk_fn(args):
        p, cells, sbi, lo_c, hi_c = args
        bodies = [p[:, :, d : d + 1] for d in range(dims)]
        cb = p.shape[0]

        def approx_part(start):
            cols = [
                jax.lax.dynamic_slice_in_dim(a, start, lanes, axis=1)[
                    :, None, :
                ]
                for a in cells
            ]
            return pair_sums(bodies, cols[:-1], cols[-1])

        def direct_part(start):
            idx, lo_b, hi_b = (
                jax.lax.dynamic_slice_in_dim(a, start, sb_block, axis=1)
                for a in (sbi, lo_c, hi_c)
            )
            dmask = idx >= 0
            safe = jnp.where(dmask, idx, 0)
            rows = sb_packed[safe]  # [C, sb_block, (D+1)*8]
            body_id = safe[:, :, None] * _SB + lane
            lane_ok = (
                dmask[:, :, None]
                & (body_id >= lo_b[:, :, None])
                & (body_id < hi_b[:, :, None])
            )
            width = sb_block * _SB
            cols = [
                rows[:, :, d * _SB : (d + 1) * _SB].reshape(cb, 1, width)
                for d in range(dims)
            ]
            sw = jnp.where(lane_ok, rows[:, :, dims * _SB :], 0.0)
            return pair_sums(bodies, cols, sw.reshape(cb, 1, width))

        acc = (jnp.zeros(p.shape[:2], f32),) * dims
        acc = blocked(acc, _live_length(cells[-1] > 0.0), lanes, approx_part)
        return blocked(acc, _live_length(sbi >= 0), sb_block, direct_part)

    def r(a):
        return a.reshape(-1, chunk, *a.shape[1:])

    out = jax.lax.map(
        chunk_fn,
        (
            r(positions_grouped),
            tuple(r(a) for a in approx),
            r(sb_idx),
            r(lo),
            r(hi),
        ),
    )
    return tuple(o.reshape(-1, s)[:n_groups] for o in out)


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
    ),
)
def bh_accelerations_grouped(
    positions: jax.Array,
    masses: jax.Array,
    *,
    g: float,
    theta: float = THETA_DEFAULT,
    max_depth: int = MAX_DEPTH_DEFAULT,
    softening: float = BH_SOFTENING,
    group_size: int | None = None,
    frontier_cap: int | None = None,
    list_cap: int | None = None,
    direct_cap: int | None = None,
    direct_cell_max: int = 32,
    direct_body_cap: int | None = None,
    group_chunk: int = 32,
    return_diagnostics: bool = False,
    n_sub: int | None = None,
):
    """Grouped Barnes-Hut accelerations [N, 2] (+ overflow [N] optional).

    ``None`` caps resolve from :func:`cap_defaults` (measured-demand
    defaults with ~2x headroom; the overflow flag guards the rest)."""
    f32 = positions.dtype
    tree = build_quadtree(positions, masses, max_depth=max_depth)
    # source bodies in Morton order (what direct ranges index into); ONE
    # packed [N, 4] row gather instead of separate position/mass gathers
    src_order = jnp.argsort(tree.codes)
    packed = jnp.concatenate(
        [positions, masses[:, None], jnp.zeros_like(masses)[:, None]],
        axis=1,
    )
    psort = packed[src_order]
    return grouped_eval(
        positions,
        tree,
        sorted_x=psort[:, 0],
        sorted_y=psort[:, 1],
        sorted_gm=jnp.asarray(g, f32) * psort[:, 2],
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
        target_codes=tree.codes,
        target_sorted=psort[:, 0:2],
        target_order=src_order,
        n_sub=n_sub,
    )


def grouped_eval(
    target_positions: jax.Array,  # [Nt, 2] bodies to accelerate
    tree: Quadtree,
    *,
    sorted_x: jax.Array,  # [Ns] source bodies in Morton order
    sorted_y: jax.Array,
    sorted_gm: jax.Array,  # [Ns] g * mass in the same order
    g: float,
    theta: float = THETA_DEFAULT,
    softening: float = BH_SOFTENING,
    group_size: int | None = None,
    frontier_cap: int | None = None,
    list_cap: int | None = None,
    direct_cap: int | None = None,
    direct_cell_max: int = 32,
    direct_body_cap: int | None = None,
    group_chunk: int = 32,
    return_diagnostics: bool = False,
    target_codes: jax.Array | None = None,
    target_sorted: jax.Array | None = None,
    target_order: jax.Array | None = None,
    n_sub: int | None = None,
    window_cells=None,
    range_offset=None,
    n_sources_hint: int | None = None,
):
    """Grouped evaluation of arbitrary targets against a prebuilt tree.

    ``sorted_*`` must be ALL source bodies in global Morton order (direct
    ranges index into them; the tree's leaf counts define the ranges).
    Targets may be any subset of the sources (multi-card: each device
    passes its local shard as targets against the gathered global
    sources).  Self-exclusion needs no indices: a target meeting its own
    singleton cell or its own entry in a direct range sees a bit-equal
    position and is dropped by the d2 > 0 guard.

    Sharded-source mode (parallel.make_dp_barnes_hut_sharded_step):
    ``sorted_*`` may instead hold only a Morton-contiguous *window* of
    the global sorted order — then ``window_cells=(c_lo, c_hi)`` (leaf
    cells the window fully covers) gates direct emission to resident
    cells (out-of-window close cells open to max-depth aggregates, the
    reference DFS's own close-cell treatment), ``range_offset`` is the
    global index of the window array's first slot, and
    ``n_sources_hint`` keys the cap calibration to the GLOBAL body
    count (caps scale with density, which the window alone understates).
    """
    n = target_positions.shape[0]

    if group_size is None:
        group_size = DEFAULT_GROUP_SIZE
    # caps scale with the SOURCE cloud size (density sets demand)
    defaults = cap_defaults(
        group_size,
        n_sources_hint if n_sources_hint else sorted_x.shape[0],
    )
    frontier_cap = frontier_cap or defaults["frontier_cap"]
    list_cap = list_cap or defaults["list_cap"]
    direct_cap = direct_cap or defaults["direct_cap"]
    direct_body_cap = direct_body_cap or defaults["direct_body_cap"]

    if target_codes is None:
        target_codes = morton_codes(
            target_positions, tree.bounds, tree.max_depth
        )

    # sort targets by Morton code so groups are spatially compact; pad to
    # a group multiple with copies of the last body (tight trailing bbox;
    # padded results are sliced off).  Callers that already hold the
    # sorted targets (bh_accelerations_grouped: targets == sources) pass
    # them in to skip a redundant row gather.
    order = jnp.argsort(target_codes) if target_order is None else target_order
    gs = min(group_size, max(n, 1))
    n_pad = ((n + gs - 1) // gs) * gs
    tsort = (
        target_positions[order] if target_sorted is None else target_sorted
    )
    tsort = jnp.concatenate(
        [tsort, jnp.broadcast_to(tsort[-1], (n_pad - n, 2))], axis=0
    )
    pg = tsort.reshape(-1, gs, 2)  # [G, S, 2]

    # Q sub-bboxes per group over slices of the sorted run (tight even
    # when the run straddles a Morton seam; see _collect_lists).  Bigger
    # groups need more sub-boxes to keep d_min tight (the union bbox of a
    # 2048-body Morton run is a large fraction of the domain).
    if n_sub is None:
        n_sub = max(4, gs // 128)
    if gs % n_sub:
        n_sub = 1
    sub = pg.reshape(pg.shape[0], n_sub, gs // n_sub, 2)
    bbox = (
        jnp.min(sub[..., 0], axis=2),
        jnp.max(sub[..., 0], axis=2),
        jnp.min(sub[..., 1], axis=2),
        jnp.max(sub[..., 1], axis=2),
    )
    (lx, ly, lm), ranges, overflow_g = _collect_lists(
        bbox,
        tree,
        theta=theta,
        softening=softening,
        frontier_caps=frontier_schedule(
            frontier_cap,
            tree.max_depth,
            n_sources_hint if n_sources_hint else sorted_x.shape[0],
        ),
        list_cap=list_cap,
        direct_cap=direct_cap,
        direct_cell_max=direct_cell_max,
        window_cells=window_cells,
    )
    if range_offset is not None:
        # window-local body indices (the sorted_* arrays start at global
        # slot ``range_offset``); in-window ranges stay non-negative
        ranges = ranges.at[:, :, 0].set(
            jnp.where(
                ranges[:, :, 1] > 0, ranges[:, :, 0] - range_offset, 0
            )
        )
    sb_cap = direct_body_cap // _SB + direct_cap
    sb_idx, sb_lo, sb_hi, ovf_b = _expand_ranges_superblocks(
        ranges, direct_cell_max, sb_cap
    )
    overflow_g = overflow_g | ovf_b
    ax, ay = evaluate_lists(
        pg,
        (lx, ly, lm),
        (sb_idx, sb_lo, sb_hi),
        superblock_pack(sorted_x, sorted_y, sorted_gm),
        g_const=g,
        softening=softening,
        group_chunk=group_chunk,
    )

    # un-sort by SORTING on the permutation: ``order`` is a permutation
    # of 0..n-1, so sorting (order, values) by order restores original
    # body order without a scatter
    axs = ax.reshape(-1)[:n]
    ays = ay.reshape(-1)[:n]
    if return_diagnostics:
        ovf_sorted = jnp.repeat(overflow_g, gs)[:n]
        _, ax_o, ay_o, ovf = jax.lax.sort(
            [order, axs, ays, ovf_sorted.astype(jnp.int32)],
            dimension=0, num_keys=1, is_stable=False,
        )
        return jnp.stack([ax_o, ay_o], axis=-1), ovf.astype(bool)
    _, ax_o, ay_o = jax.lax.sort(
        [order, axs, ays], dimension=0, num_keys=1, is_stable=False
    )
    return jnp.stack([ax_o, ay_o], axis=-1)
