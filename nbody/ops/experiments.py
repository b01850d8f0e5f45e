"""Measured-but-not-shipped traversal variants (kept as tested utilities).

The reference keeps its dev-log findings in ``observations.txt`` rather
than in ``project.cu``; this module is the same discipline for our own
negative results.  Both functions below implement the *merged-run* direct
pipeline: interval-union the per-cell Morton body ranges emitted by the
grouped traversal into maximal runs, then enumerate each run's
superblocks without the per-cell boundary double-fetch.

Measured end-to-end (PERF.md "Morton run merging"), the pipeline LOSES to
the static per-cell expansion that both shipped engines use
(ops/bh_grouped._expand_ranges_superblocks) on the accelerator the
engine was first built for, with run-cap overflow on 2/128 groups at 3D
256K; not measured on the GPU.  The
enumeration overhead exceeds the boundary-superblock slack it removes,
and near-field cells that refuse to merge push past any small run cap.
Kept because the building blocks (data-parallel interval union; prefix-
sum + scatter-mark + cummax run expansion) are measured, unit-tested
formulations that a future variant may reuse.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .bh_grouped import _INT_MAX, _sort_compact


def merge_ranges(ranges: jax.Array, cap: int | None = None):
    """Merge overlapping/adjacent per-group body ranges into maximal runs.

    Direct cells emitted by the traversal are Morton-contiguous slices of
    the sorted body array, and a group's near field is mostly ONE
    contiguous Morton run around the group plus a few satellites — so
    interval union collapses thousands of per-cell ranges into a handful
    of runs.

    Pure data-parallel interval union per row: sort by start, running
    max of ends, run boundaries where a start exceeds every prior end,
    compact starts/ends of each run.  Merging only ever reduces the
    entry count, so the output reuses the input capacity and cannot
    overflow.

    ranges: [G, D, 2] (start, count), zero-count padded.  Returns
    ([G, cap, 2] merged (start, count) left-compacted, overflow [G]).
    ``cap`` defaults to min(D, 256); more runs than ``cap`` raises the
    overflow flag (the usual cap discipline).
    """
    starts = ranges[:, :, 0]
    counts = ranges[:, :, 1]
    if cap is None:
        cap = min(ranges.shape[1], 256)
    valid = counts > 0
    ends = starts + counts
    key = jnp.where(valid, starts, _INT_MAX)
    s_sorted, e_sorted = jax.lax.sort(
        [key, jnp.where(valid, ends, 0)],
        dimension=1,
        num_keys=1,
        is_stable=False,
    )
    v_sorted = s_sorted < _INT_MAX
    cmax = jax.lax.cummax(e_sorted, axis=1)
    prev_cmax = jnp.concatenate(
        [jnp.full_like(cmax[:, :1], -1), cmax[:, :-1]], axis=1
    )
    new_run = v_sorted & (s_sorted > prev_cmax)
    # last element of each run: the next entry starts a new run or is pad
    nxt = jnp.concatenate(
        [new_run[:, 1:] | ~v_sorted[:, 1:], jnp.ones_like(new_run[:, :1])],
        axis=1,
    )
    is_last = v_sorted & nxt
    # the k-th new_run and the k-th is_last delimit the same run, so the
    # two compactions zip by position
    (ms,), ovf_s = _sort_compact(
        new_run, [jnp.where(new_run, s_sorted, 0)], cap
    )
    (me,), _ = _sort_compact(is_last, [jnp.where(is_last, cmax, 0)], cap)
    return (
        jnp.stack([ms, jnp.maximum(me - ms, 0)], axis=-1),
        ovf_s,
    )


def expand_runs_superblocks(ranges: jax.Array, sb_cap: int):
    """Expand merged body runs to a compact per-group superblock list.

    Unlike the shipped static per-range expansion (sized by
    ``direct_cell_max``), runs out of :func:`merge_ranges` have unbounded
    length, so the expansion enumerates a variable number of superblocks
    per run: exclusive prefix sums give each run's output offset, and a
    scatter-mark + running-max fill resolves each output slot's run —
    all static shapes.

    Returns (sb_idx [G, C], lo [G, C], hi [G, C], overflow [G]); invalid
    entries have sb_idx == -1.  When a group's superblock total exceeds
    ``sb_cap`` its overflow flag is set and the spill is dropped — spill
    never crosses into another group's segment.
    """
    g, d, _ = ranges.shape
    _sb = 8  # bodies per superblock (ops/bh_grouped._SB)
    starts = ranges[:, :, 0]
    counts = ranges[:, :, 1]
    ends = starts + counts
    first = starts >> 3
    last = (ends - 1) >> 3  # arithmetic shift: count==0 -> last < first
    n_sb = jnp.maximum(last - first + 1, 0)  # [G, D]
    total = jnp.sum(n_sb, axis=1)  # [G]
    offsets = jnp.cumsum(n_sb, axis=1) - n_sb  # exclusive prefix sums

    # run index covering each output slot: scatter each run's index at
    # its output offset, then a running max fills the gaps.  (A vmapped
    # searchsorted lowers to serial binary searches at these shapes; the
    # scatter is tiny because the merged-run input width D is small.)
    valid = n_sb > 0
    kidx = jax.lax.broadcasted_iota(jnp.int32, (g, d), 1)
    # flat 1D scatter (segment_max) — the same proven pattern as the
    # tree's leaf scatter; 2D advanced-index .at[].max compiled
    # pathologically (>30 min) on an earlier toolchain.  Offsets at or past
    # sb_cap go to the out-of-bounds drop segment: an overflowing group
    # must not spill marks into the NEXT group's row (its own overflow
    # flag is set below; the neighbour's list stays intact).
    row0 = jnp.arange(g, dtype=jnp.int32)[:, None] * sb_cap
    flat_pos = jnp.where(
        valid & (offsets < sb_cap), row0 + offsets, g * sb_cap
    )
    marks = jax.ops.segment_max(
        kidx.reshape(-1),
        flat_pos.reshape(-1),
        num_segments=g * sb_cap,
        indices_are_sorted=False,
    ).reshape(g, sb_cap)
    marks = jnp.maximum(marks, 0)  # empty segments return INT_MIN
    k = jax.lax.cummax(marks, axis=1)  # [G, C]
    j = jnp.arange(sb_cap, dtype=jnp.int32)
    # ONE flat row gather for the three per-run fields (the proven
    # pattern in ops/bh_grouped: flatten the [G, D] table and gather
    # g*D + k rows; per-row latency, width free)
    packed = jnp.stack(
        [first - offsets, starts, ends], axis=-1
    ).reshape(g * d, 3)
    flat = jnp.arange(g, dtype=jnp.int32)[:, None] * d + k
    rows = packed[flat]  # [G, C, 3]
    sb = rows[:, :, 0] + j[None, :]
    mask = j[None, :] < total[:, None]
    return (
        jnp.where(mask, sb, -1),
        jnp.where(mask, rows[:, :, 1], 0),
        jnp.where(mask, rows[:, :, 2], 0),
        total > sb_cap,
    )
