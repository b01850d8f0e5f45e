"""Implicit dense quadtree pyramid: the data-parallel tree structure.

The reference builds a pointer-chasing adaptive quadtree on the host every
step (buildTree project.cu:575-591: recursive QuadInsert + recursive
ComputeMass) and ships it to the GPU (project.cu:968).  That structure is
hostile to a data-parallel device (dynamic size, pointer chasing,
per-node recursion), so the
tree is re-architected as a *dense implicit pyramid*:

* level L = max_depth is a 2^L x 2^L cell grid; each body maps to a cell
  via its Morton code; per-cell mass / mass-weighted position / occupancy
  count are built with one segment-sum each (the parallel-friendly build
  the reference's report wishes for: "Morton codes + sorting + level-wise
  subtree builds", project_report.pdf p.7);
* coarser levels are 4->1 reductions (Morton order makes the 4 children of
  cell c contiguous at 4c..4c+3), replacing recursive ComputeMass;
* total nodes = (4^(max_depth+1)-1)/3 = 349,525 for max_depth=9 — exactly
  the reference's QUADTREE_MAX_SIZE (project.cu:62) — about 5.6 MB of f32
  fields.

Equivalence to the adaptive tree (used by the traversal in barnes_hut.py):
a cell with count==1 *is* the adaptive tree's singleton leaf (same mass and
COM at every ancestor level, so accepting it at any level along the chain
yields a bit-equal interaction); a cell with count>=2 at level max_depth is
the reference's aggregated max-depth pseudo-body (project.cu:358-382);
empty cells correspond to the empty children the reference skips.

Cell assignment uses the reference's *recursive midpoint* rule
(DetermineChild, project.cu:348-356: >= goes to the high half, midpoints
recomputed per level as (lo+hi)/2), not a linear quantisation, so cell
boundaries match the oracle bit-for-bit in matching precision.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import MAX_DEPTH_DEFAULT, ROOT_PAD_FRACTION


class TreeLevel(NamedTuple):
    mass: jax.Array  # [4^level] total mass per cell
    comx: jax.Array  # [4^level] centre of mass x (0 where empty)
    comy: jax.Array  # [4^level]
    count: jax.Array  # [4^level] int32 bodies per cell


# Column layout of the packed per-level "raw" rows [4^level, 8].  The
# raw rows are the hot-path representation: one 8-wide row gather / scatter
# moves a whole row per index (gathers are latency-bound), so the traversal
# gathers whole rows and derives COM (division) *after* the gather, on the
# small [groups, frontier] arrays.  OCC holds the 4 child-occupancy bits
# (value 0..15, exact in f32), replacing a second child-count gather.
RAW_M, RAW_MX, RAW_MY, RAW_SX, RAW_SY, RAW_CNT, RAW_OCC, RAW_PAD = range(8)


class Quadtree(NamedTuple):
    levels: Tuple[TreeLevel, ...]  # levels[0] = root .. levels[max_depth]
    bounds: jax.Array  # [4] x_min, x_max, y_min, y_max (padded root box)
    codes: jax.Array  # [N] int32 leaf-cell Morton code per body
    raw: Tuple[jax.Array, ...] = ()  # packed [4^level, 8] rows per level
    #   (cols per RAW_*); the TreeLevel views above are derived slices that
    #   XLA dead-code-eliminates when a consumer only touches ``raw``

    @property
    def max_depth(self) -> int:
        return len(self.levels) - 1


def root_bounds(positions: jax.Array) -> jax.Array:
    """ComputeRootBounds (project.cu:536-573): min/max + 10% of the max
    dimension as pad; 1e-6 fallback for a degenerate (single-point) cloud."""
    x = positions[:, 0]
    y = positions[:, 1]
    x_min, x_max = jnp.min(x), jnp.max(x)
    y_min, y_max = jnp.min(y), jnp.max(y)
    max_dim = jnp.maximum(x_max - x_min, y_max - y_min)
    pad = jnp.where(max_dim == 0.0, 1e-6, ROOT_PAD_FRACTION * max_dim)
    return jnp.stack([x_min - pad, x_max + pad, y_min - pad, y_max + pad])


def morton_codes(
    positions: jax.Array, bounds: jax.Array, max_depth: int
) -> jax.Array:
    """Per-body leaf-cell Morton code by recursive midpoint subdivision.

    Bit layout: two bits per level, root-first; the low bit of each pair is
    the x decision, the high bit the y decision — matching the reference's
    child numbering 0=BL, 1=BR, 2=TL, 3=TR (DetermineChild,
    project.cu:348-356).  The cell index of a body at level l is
    ``code >> 2*(max_depth - l)``.
    """
    x = positions[:, 0]
    y = positions[:, 1]
    x_lo = jnp.full_like(x, bounds[0])
    x_hi = jnp.full_like(x, bounds[1])
    y_lo = jnp.full_like(y, bounds[2])
    y_hi = jnp.full_like(y, bounds[3])
    code = jnp.zeros(x.shape, dtype=jnp.int32)
    for _ in range(max_depth):
        mid_x = (x_lo + x_hi) * 0.5
        mid_y = (y_lo + y_hi) * 0.5
        bx = (x >= mid_x).astype(jnp.int32)
        by = (y >= mid_y).astype(jnp.int32)
        x_lo = jnp.where(bx == 1, mid_x, x_lo)
        x_hi = jnp.where(bx == 1, x_hi, mid_x)
        y_lo = jnp.where(by == 1, mid_y, y_lo)
        y_hi = jnp.where(by == 1, y_hi, mid_y)
        code = (code << 2) | (by << 1) | bx
    return code


def leaf_raw(
    positions: jax.Array,
    masses: jax.Array,
    codes: jax.Array,
    max_depth: int,
) -> jax.Array:
    """Packed per-leaf-cell aggregate rows [4^max_depth, 8] via ONE
    scatter-add — the parallel-insert replacement for QuadInsert.

    Scatters are latency-bound per row, not per byte, so the six fields
    (mass, mass*x, mass*y, x, y, count — cols per RAW_*) ride one 8-wide
    row scatter instead of six scatters.  Each device computes this over
    its *local* bodies; a single psum of the one array over the mesh
    yields the global tree (see nbody.parallel).

    The unweighted position sums (RAW_SX/RAW_SY) exist so that a cell
    containing exactly one body gets a COM *bit-equal* to that body's
    position (the weighted m*x/m round-trip is not exact in f32):
    singleton cells then self-exclude in interaction kernels via the
    d2 > 0 guard, replacing the reference's occupant-index bookkeeping
    (project.cu:646)."""
    n_leaf = 4**max_depth
    x = positions[:, 0]
    y = positions[:, 1]
    packed = jnp.stack(
        [
            masses,
            masses * x,
            masses * y,
            x,
            y,
            jnp.ones(codes.shape, masses.dtype),
            jnp.zeros(codes.shape, masses.dtype),
            jnp.zeros(codes.shape, masses.dtype),
        ],
        axis=1,
    )  # [N, 8]
    return jax.ops.segment_sum(packed, codes, num_segments=n_leaf)


def leaf_aggregates(
    positions: jax.Array,
    masses: jax.Array,
    codes: jax.Array,
    max_depth: int,
):
    """Unpacked view of :func:`leaf_raw` (compat shim for callers that
    want individual field arrays)."""
    agg = leaf_raw(positions, masses, codes, max_depth)
    return (
        agg[:, RAW_M],
        agg[:, RAW_MX],
        agg[:, RAW_MY],
        agg[:, RAW_SX],
        agg[:, RAW_SY],
        agg[:, RAW_CNT].astype(jnp.int32),
    )


def _finish_level(raw: jax.Array, dtype) -> TreeLevel:
    """Derive the unpacked TreeLevel view from packed raw rows.

    Pure slices + elementwise work: XLA dead-code-eliminates it for
    consumers that traverse ``Quadtree.raw`` directly (the grouped
    engine divides after its row gathers instead)."""
    m = raw[:, RAW_M]
    cnt = raw[:, RAW_CNT].astype(jnp.int32)
    safe = jnp.where(m > 0, m, 1.0).astype(dtype)
    # exact position for singleton cells (sums of a single term are
    # exact at every level of the chain)
    comx = jnp.where(
        cnt == 1, raw[:, RAW_SX], raw[:, RAW_MX] / safe
    ).astype(dtype)
    comy = jnp.where(
        cnt == 1, raw[:, RAW_SY], raw[:, RAW_MY] / safe
    ).astype(dtype)
    return TreeLevel(mass=m.astype(dtype), comx=comx, comy=comy, count=cnt)


def _reduction_matrix(dtype) -> jax.Array:
    """[64, 8] matrix encoding one pyramid 4->1 reduction as a matmul.

    Input row (per parent cell): [child rows flattened (4x8) | (>0) mask
    of the same 32 values].  Output: summed fields 0..5, child-occupancy
    bits (RAW_OCC), zero pad.  One HIGHEST-precision matmul replaces the
    slice + reduce + concat chain (whether a reshape-and-sum is faster on
    the GPU is ROADMAP Speed #9)."""
    import numpy as np

    w = np.zeros((64, 8), dtype=np.float64)
    for j in range(4):
        for f in (RAW_M, RAW_MX, RAW_MY, RAW_SX, RAW_SY, RAW_CNT):
            w[j * 8 + f, f] = 1.0
        w[32 + j * 8 + RAW_CNT, RAW_OCC] = float(1 << j)
    return jnp.asarray(w, dtype)


def pyramid_from_raw(
    raw: jax.Array,
    bounds: jax.Array,
    codes: jax.Array,
    max_depth: int,
    dtype=jnp.float32,
) -> Quadtree:
    """4->1 reductions up the pyramid (replaces recursive ComputeMass).

    Each reduction also packs the 4 child-occupancy bits into RAW_OCC of
    the parent row, so the traversal can prune empty children from the
    parent's own gathered row (no second gather into the child level).
    The reduction is one HIGHEST-precision matmul per level (see
    _reduction_matrix); singleton-cell position sums stay exact because
    their chains only ever add zeros."""
    w = _reduction_matrix(raw.dtype)
    raws: List[jax.Array] = [raw]
    for _ in range(max_depth):
        v = raw.reshape(-1, 32)
        b = jnp.concatenate([v, (v > 0).astype(raw.dtype)], axis=1)
        raw = jax.lax.dot_general(
            b,
            w,
            (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )
        raws.append(raw)
    raws.reverse()  # root first
    levels = tuple(_finish_level(r, dtype) for r in raws)
    return Quadtree(
        levels=levels, bounds=bounds, codes=codes, raw=tuple(raws)
    )


def pyramid_from_leaves(
    m: jax.Array,
    mx: jax.Array,
    my: jax.Array,
    sx: jax.Array,
    sy: jax.Array,
    cnt: jax.Array,
    bounds: jax.Array,
    codes: jax.Array,
    max_depth: int,
    dtype=jnp.float32,
) -> Quadtree:
    """Compat shim: pack unpacked leaf fields and build the raw pyramid."""
    raw = jnp.stack(
        [
            m,
            mx,
            my,
            sx,
            sy,
            cnt.astype(m.dtype),
            jnp.zeros_like(m),
            jnp.zeros_like(m),
        ],
        axis=1,
    )
    return pyramid_from_raw(raw, bounds, codes, max_depth, dtype=dtype)


@functools.partial(jax.jit, static_argnames=("max_depth",))
def build_quadtree(
    positions: jax.Array,
    masses: jax.Array,
    max_depth: int = MAX_DEPTH_DEFAULT,
    bounds: jax.Array | None = None,
) -> Quadtree:
    """Whole-tree build as one packed scatter + 4->1 reductions (no
    recursion)."""
    if bounds is None:
        bounds = root_bounds(positions)
    codes = morton_codes(positions, bounds, max_depth)
    raw = leaf_raw(positions, masses, codes, max_depth)
    return pyramid_from_raw(
        raw, bounds, codes, max_depth, dtype=positions.dtype
    )


def level_cell_size(bounds: jax.Array, level: int) -> jax.Array:
    """node_size = max cell dimension at a level (the reference computes
    max(dx, dy) per node, project.cu:637-639; every cell at a level shares
    the same extent in the dense pyramid)."""
    sx = (bounds[1] - bounds[0]) / (1 << level)
    sy = (bounds[3] - bounds[2]) / (1 << level)
    return jnp.maximum(sx, sy)
