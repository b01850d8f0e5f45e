"""Implicit dense octree pyramid: the 3D generalisation of ops.tree.

The reference is 2D-only (``N_DIM = 2``, project.cu:28) and its report
names the octree / ``N_DIM = 3`` extension as *the* 3D generalisation
(project_report.pdf p.8); its ``plot_3d.py`` gestures at 3D output but is
non-functional as committed.  This module delivers that generalisation
with the same architecture as the 2D quadtree (ops/tree.py):

* level L = max_depth is a 2^L x 2^L x 2^L cell grid; bodies map to cells
  via 3-bit-per-level Morton codes (recursive midpoint subdivision, the
  3D analogue of DetermineChild, project.cu:348-356);
* per-cell aggregates ride ONE 16-wide row scatter (scatters are
  latency-bound per row: width is free, rows are not — see PERF.md);
* coarser levels are 8->1 reductions; Morton order makes the 8 children
  of cell c contiguous at 8c..8c+7, and each reduction is a single
  f32-HIGHEST matmul ``[C/8, 256] @ [256, 16]`` that sums the
  seven fields AND packs the 8 child-occupancy bits (values <= 255, exact
  in f32) — the same design as the 2D pyramid's ``[C/4, 64] @ [64, 8]``.

Row layout (16-wide):
    [m, m*x, m*y, m*z, sum x, sum y, sum z, count, occ, 0*7]
The unweighted position sums give singleton cells COMs *bit-equal* to the
body position at every ancestor level (sums of one term stay exact), so
interaction kernels self-exclude via the d2 > 0 guard with no occupant
bookkeeping — identical to the 2D design (ops/tree.py leaf_raw).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import ROOT_PAD_FRACTION

# Column layout of the packed per-level raw rows [8^level, 16].
R3_M, R3_MX, R3_MY, R3_MZ, R3_SX, R3_SY, R3_SZ, R3_CNT, R3_OCC = range(9)
_W = 16  # row width (16 = next power of two above the 9 live fields)

# Default depth: ~0.25 bodies/leaf like the 2D default (512^2 cells for
# 64K bodies -> here 8^ceil(log8(4N)) cells), capped at 7 to bound the
# leaf level at 8^7 = 2,097,152 rows (134 MB of f32 raw; at 64K depth 7
# adds scatter+pyramid work for no accuracy gain).
MAX_DEPTH3_DEFAULT = 7


def default_max_depth3(n_bodies: int) -> int:
    import math

    return min(
        MAX_DEPTH3_DEFAULT,
        max(4, math.ceil(math.log(max(4 * n_bodies, 8), 8))),
    )


class Octree(NamedTuple):
    raw: Tuple[jax.Array, ...]  # [8^level, 16] packed rows, root first
    bounds: jax.Array  # [6] x_min, x_max, y_min, y_max, z_min, z_max
    codes: jax.Array  # [N] int32 leaf-cell Morton code per body

    @property
    def max_depth(self) -> int:
        return len(self.raw) - 1

    def leaf_counts(self) -> jax.Array:
        return self.raw[self.max_depth][:, R3_CNT].astype(jnp.int32)


def root_bounds_3d(positions: jax.Array) -> jax.Array:
    """3D ComputeRootBounds analogue (project.cu:536-573 semantics: min/max
    + 10% of the max dimension as pad, 1e-6 degenerate fallback)."""
    lo = jnp.min(positions, axis=0)  # [3]
    hi = jnp.max(positions, axis=0)
    max_dim = jnp.max(hi - lo)
    pad = jnp.where(max_dim == 0.0, 1e-6, ROOT_PAD_FRACTION * max_dim)
    return jnp.stack(
        [lo[0] - pad, hi[0] + pad, lo[1] - pad, hi[1] + pad,
         lo[2] - pad, hi[2] + pad]
    )


def morton_codes_3d(
    positions: jax.Array, bounds: jax.Array, max_depth: int
) -> jax.Array:
    """Per-body leaf-cell Morton code by recursive midpoint subdivision.

    Three bits per level, root-first; per level the low bit is the x
    decision, then y, then z (extending the reference's 2D child
    numbering, DetermineChild project.cu:348-356, by a z axis).  The cell
    index of a body at level l is ``code >> 3*(max_depth - l)``.
    max_depth <= 10 fits int32 (30 bits)."""
    x, y, z = positions[:, 0], positions[:, 1], positions[:, 2]
    x_lo = jnp.full_like(x, bounds[0])
    x_hi = jnp.full_like(x, bounds[1])
    y_lo = jnp.full_like(y, bounds[2])
    y_hi = jnp.full_like(y, bounds[3])
    z_lo = jnp.full_like(z, bounds[4])
    z_hi = jnp.full_like(z, bounds[5])
    code = jnp.zeros(x.shape, dtype=jnp.int32)
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
        code = (code << 3) | (bz << 2) | (by << 1) | bx
    return code


def leaf_raw_3d(
    positions: jax.Array,
    masses: jax.Array,
    codes: jax.Array,
    max_depth: int,
) -> jax.Array:
    """Packed per-leaf-cell aggregates [8^max_depth, 16] via ONE
    scatter-add (the parallel-insert replacement for recursive insert;
    same design as the 2D leaf_raw, ops/tree.py)."""
    n_leaf = 8**max_depth
    x, y, z = positions[:, 0], positions[:, 1], positions[:, 2]
    zero = jnp.zeros(codes.shape, masses.dtype)
    packed = jnp.stack(
        [
            masses, masses * x, masses * y, masses * z,
            x, y, z,
            jnp.ones(codes.shape, masses.dtype),
        ]
        + [zero] * (_W - 8),
        axis=1,
    )  # [N, 16]
    return jax.ops.segment_sum(packed, codes, num_segments=n_leaf)


def _reduction_matrix_3d(dtype) -> jax.Array:
    """[2*8*_W, _W] matrix encoding one pyramid 8->1 reduction as a matmul.

    Input row per parent cell: [8 child rows flattened (8x16) | (>0) mask
    of the same 128 values].  Output: summed fields M..CNT, the 8
    child-occupancy bits in R3_OCC (from the mask of each child's CNT),
    zero pads.  One matmul per level replaces slice+reduce+concat
    chains."""
    import numpy as np

    w = np.zeros((2 * 8 * _W, _W), dtype=np.float64)
    for j in range(8):
        for f in (R3_M, R3_MX, R3_MY, R3_MZ, R3_SX, R3_SY, R3_SZ, R3_CNT):
            w[j * _W + f, f] = 1.0
        w[8 * _W + j * _W + R3_CNT, R3_OCC] = float(1 << j)
    return jnp.asarray(w, dtype)


def pyramid_from_raw_3d(
    raw: jax.Array,
    bounds: jax.Array,
    codes: jax.Array,
    max_depth: int,
) -> Octree:
    """8->1 reductions up the pyramid; one f32-HIGHEST matmul per level
    (see _reduction_matrix_3d).  Singleton position sums stay exact
    because their chains only ever add zeros."""
    w = _reduction_matrix_3d(raw.dtype)
    raws: List[jax.Array] = [raw]
    for _ in range(max_depth):
        v = raw.reshape(-1, 8 * _W)
        b = jnp.concatenate([v, (v > 0).astype(raw.dtype)], axis=1)
        raw = jax.lax.dot_general(
            b, w, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )
        raws.append(raw)
    raws.reverse()  # root first
    return Octree(raw=tuple(raws), bounds=bounds, codes=codes)


@functools.partial(jax.jit, static_argnames=("max_depth",))
def build_octree(
    positions: jax.Array,
    masses: jax.Array,
    max_depth: int = MAX_DEPTH3_DEFAULT,
    bounds: jax.Array | None = None,
) -> Octree:
    """Whole-octree build as one packed scatter + 8->1 matmul reductions."""
    if bounds is None:
        bounds = root_bounds_3d(positions)
    codes = morton_codes_3d(positions, bounds, max_depth)
    raw = leaf_raw_3d(positions, masses, codes, max_depth)
    return pyramid_from_raw_3d(raw, bounds, codes, max_depth)


def level_cell_size_3d(bounds: jax.Array, level: int) -> jax.Array:
    """node_size = max cell dimension at a level (3D analogue of the
    reference's per-node max(dx, dy), project.cu:637-639)."""
    sx = (bounds[1] - bounds[0]) / (1 << level)
    sy = (bounds[3] - bounds[2]) / (1 << level)
    sz = (bounds[5] - bounds[4]) / (1 << level)
    return jnp.maximum(jnp.maximum(sx, sy), sz)
