"""Stackless, masked Barnes-Hut traversal over the dense pyramid.

Data-parallel redesign of the reference's per-body divergent stack DFS (CPU:
std::stack, project.cu:593-675; GPU: fixed int[3*MAX_DEPTH+1] register
stack, project.cu:679-793).  Instead of a stack per body, all bodies
advance *level-synchronously* with a bounded frontier of candidate cells:

  level 0 frontier = {root}
  at each level: gather (mass, com, count) for frontier cells,
    accept  = non-empty and (singleton | theta-criterion | max-depth)
    open    = non-empty multi-body cells failing theta above max depth
  accepted cells contribute w * disp with w = G*M/(d2*(d+eps)); opened
  cells' non-empty children are compacted into the next level's frontier.

Acceptance semantics are provably force-equal to the reference traversal:

* theta test ``node_size / d < THETA`` with d = ||COM - p|| + 1e-15 and
  node_size = max cell extent (project.cu:641-643/757, 634/748, 637-639).
* zero-mass skip (project.cu:617/731) == the count>0 & mass>threshold mask.
* a count==1 cell is the adaptive tree's singleton leaf: identical mass
  and COM at every level of its chain, so accepting at first encounter is
  bit-equal to the reference accepting wherever its leaf happens to sit.
* count>=2 cells at max_depth are the reference's aggregated pseudo-bodies
  (project.cu:358-382); they are accepted unconditionally (they are leaves
  there) *including by their own member bodies* — the reference quirk
  where an aggregated cell's occupants feel their own aggregate
  (PARTICLE_INDEX == -1 defeats the self-skip, project.cu:378/760).
* self-skip: a singleton cell equal to the body's own cell holds exactly
  that body — skipped, covering both ``occ == i`` and the negative
  encoding ``(occ+2) == -i`` (project.cu:646/760).

The frontier is fixed-capacity (``frontier_cap``), the data-parallel analogue of the
reference's fixed stack bound (3*depth+1, project.cu:708): geometry bounds
live frontier size (rejected cells all lie within ~2/theta cell widths of
the body), and an overflow flag is returned for diagnostics, mirroring the
reference's in-kernel stack-overflow printf guards (project.cu:712-721).
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
from .tree import Quadtree, build_quadtree, level_cell_size


def _frontier_caps(max_depth: int, cap: int) -> list:
    caps = [1]
    for level in range(1, max_depth + 1):
        caps.append(min(4 * caps[-1], cap, 4**level))
    return caps


def _traverse_chunk(
    px: jax.Array,  # [B]
    py: jax.Array,  # [B]
    own_codes: jax.Array,  # [B] leaf Morton code of each body
    tree: Quadtree,
    *,
    theta: float,
    softening: float,
    g: float,
    frontier_cap: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Returns (acc_x [B], acc_y [B], overflowed [B] bool)."""
    max_depth = tree.max_depth
    caps = _frontier_caps(max_depth, frontier_cap)
    b = px.shape[0]
    f32 = px.dtype

    acc_x = jnp.zeros((b,), f32)
    acc_y = jnp.zeros((b,), f32)
    overflow = jnp.zeros((b,), bool)
    frontier = jnp.zeros((b, 1), jnp.int32)  # root

    for level in range(max_depth + 1):
        lv = tree.levels[level]
        valid = frontier >= 0
        idx = jnp.where(valid, frontier, 0)
        m = lv.mass[idx]  # [B, F]
        cx = lv.comx[idx]
        cy = lv.comy[idx]
        cnt = lv.count[idx]

        dx = cx - px[:, None]
        dy = cy - py[:, None]
        d2 = dx * dx + dy * dy
        d = jnp.sqrt(d2) + jnp.asarray(softening, f32)
        size = level_cell_size(tree.bounds, level).astype(f32)
        theta_ok = size < theta * d  # size/d < theta without the divide

        nonempty = valid & (cnt > 0) & (m > MASS_SKIP_THRESHOLD)
        singleton = cnt == 1
        at_max = level == max_depth
        accept = nonempty & (singleton | theta_ok | at_max)

        own_cell = own_codes >> (2 * (max_depth - level))
        self_skip = singleton & (frontier == own_cell[:, None])
        accept = accept & ~self_skip

        # w = G*M / (d2 * (d + eps)); guard d2 == 0 (body exactly on an
        # accepted COM) to 0 instead of the reference's inf*0 = NaN.
        w = jnp.where(
            accept & (d2 > 0), g * m / (jnp.where(d2 > 0, d2, 1.0) * d), 0.0
        )
        acc_x = acc_x + jnp.sum(w * dx, axis=1)
        acc_y = acc_y + jnp.sum(w * dy, axis=1)

        if level == max_depth:
            break

        open_ = nonempty & ~singleton & ~theta_ok
        # children cells at level+1 (Morton: 4c .. 4c+3); keep non-empty only
        f = frontier.shape[1]
        children = (idx[:, :, None] * 4 + jnp.arange(4, dtype=jnp.int32)).reshape(
            b, 4 * f
        )
        child_cnt = tree.levels[level + 1].count[children]
        cmask = (
            jnp.repeat(open_, 4, axis=1) & (child_cnt > 0)
        )  # [B, 4F]

        next_cap = caps[level + 1]
        pos = jnp.cumsum(cmask.astype(jnp.int32), axis=1) - 1
        overflow = overflow | (jnp.max(jnp.where(cmask, pos, -1), axis=1) >= next_cap)
        col = jnp.where(cmask, jnp.minimum(pos, next_cap), next_cap)
        rows = jax.lax.broadcasted_iota(jnp.int32, (b, 4 * f), 0)
        nxt = jnp.full((b, next_cap + 1), -1, jnp.int32)
        nxt = nxt.at[rows, col].set(children, mode="drop")
        frontier = nxt[:, :next_cap]

    return acc_x, acc_y, overflow


def traverse_accelerations(
    positions: jax.Array,
    own_codes: jax.Array,
    tree: Quadtree,
    *,
    g: float,
    theta: float = THETA_DEFAULT,
    softening: float = BH_SOFTENING,
    frontier_cap: int = 256,
    body_chunk: int = 8192,
):
    """Traverse a prebuilt tree for the given bodies.

    Memory is bounded by processing bodies in chunks of ``body_chunk``
    (each chunk holds [chunk, frontier_cap] working arrays); the tree is
    shared by all chunks.  Used directly by the multi-chip step, where
    each device traverses its own body shard against the psum-replicated
    tree.  Returns (acc [N, 2], overflowed [N] bool).
    """
    n = positions.shape[0]
    f32 = positions.dtype
    chunk = min(body_chunk, max(n, 1))
    n_pad = ((n + chunk - 1) // chunk) * chunk
    px = jnp.zeros((n_pad,), f32).at[:n].set(positions[:, 0])
    py = jnp.zeros((n_pad,), f32).at[:n].set(positions[:, 1])
    # padded bodies get own_code -1: never matches a cell -> no self skip;
    # their (garbage) accelerations are sliced off below.
    own = jnp.full((n_pad,), -1, jnp.int32).at[:n].set(own_codes)

    def one_chunk(args):
        cpx, cpy, cown = args
        return _traverse_chunk(
            cpx,
            cpy,
            cown,
            tree,
            theta=theta,
            softening=softening,
            g=g,
            frontier_cap=frontier_cap,
        )

    ax, ay, ovf = jax.lax.map(
        one_chunk,
        (
            px.reshape(-1, chunk),
            py.reshape(-1, chunk),
            own.reshape(-1, chunk),
        ),
    )
    acc = jnp.stack([ax.reshape(-1)[:n], ay.reshape(-1)[:n]], axis=-1)
    return acc, ovf.reshape(-1)[:n]


@functools.partial(
    jax.jit,
    static_argnames=(
        "g",
        "theta",
        "max_depth",
        "softening",
        "frontier_cap",
        "body_chunk",
        "return_diagnostics",
    ),
)
def bh_accelerations(
    positions: jax.Array,
    masses: jax.Array,
    *,
    g: float,
    theta: float = THETA_DEFAULT,
    max_depth: int = MAX_DEPTH_DEFAULT,
    softening: float = BH_SOFTENING,
    frontier_cap: int = 256,
    body_chunk: int = 8192,
    return_diagnostics: bool = False,
):
    """Build + traverse: Barnes-Hut accelerations [N, 2] (optionally +
    overflow flags [N])."""
    tree = build_quadtree(positions, masses, max_depth=max_depth)
    acc, ovf = traverse_accelerations(
        positions,
        tree.codes,
        tree,
        g=g,
        theta=theta,
        softening=softening,
        frontier_cap=frontier_cap,
        body_chunk=body_chunk,
    )
    if return_diagnostics:
        return acc, ovf
    return acc
