"""Opt-in per-step metrics (SURVEY.md 5.5).

The reference's observability is stdout timing lines + text dump files;
its dev log (observations.txt) tracks tree size and per-phase costs by
hand.  Here those become a machine-readable per-step CSV: conserved
quantities (energy, momentum) and tree statistics (node counts by level,
max occupied depth) — the quantities the reference's report reasons about
(tree size ~3N, observations.txt:59-65; collapse dynamics pp.6).
"""

from __future__ import annotations

import csv
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..physics import (
    kinetic_energy,
    potential_energy_scalable,
    total_momentum,
)
from ..state import SimState


class MetricsWriter:
    """Accumulates one row per step; writes CSV on flush."""

    FIELDS = [
        "step",
        "time",
        "kinetic_energy",
        "potential_energy",
        "total_energy",
        "momentum_x",
        "momentum_y",
        "tree_nodes",
        "tree_max_depth",
    ]

    def __init__(self, path: str, g: float, with_potential: bool = True):
        self.path = path
        self.g = g
        # potential is O(N^2) FLOPs but bounded memory at any N
        # (physics.potential_energy_scalable: chunked XLA); opt out to
        # skip the FLOPs entirely
        self.with_potential = with_potential
        self.rows = []

    def record(self, state: SimState, tree_stats: Optional[dict] = None):
        ke = float(kinetic_energy(state))
        if self.with_potential:
            pe = float(potential_energy_scalable(state, self.g))
        else:
            pe = float("nan")
        mom = np.asarray(total_momentum(state))
        row = {
            "step": int(state.step),
            "time": float(state.time),
            "kinetic_energy": ke,
            "potential_energy": pe,
            "total_energy": ke + pe,
            "momentum_x": float(mom[0]),
            "momentum_y": float(mom[1]),
            "tree_nodes": (tree_stats or {}).get("nodes", ""),
            "tree_max_depth": (tree_stats or {}).get("max_depth", ""),
        }
        self.rows.append(row)

    def flush(self):
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self.FIELDS)
            w.writeheader()
            w.writerows(self.rows)


def tree_stats(positions, masses, max_depth: int = 9) -> dict:
    """Occupied-node statistics of the current tree — the reference's
    'practical tree size' observable (observations.txt:59-65)."""
    from ..ops.tree import build_quadtree

    tree = build_quadtree(positions, masses, max_depth=max_depth)
    occupied = [int(jnp.sum(lv.count > 0)) for lv in tree.levels]
    # deepest level at which the adaptive tree would have nodes: a level
    # is materialised iff some parent has >= 2 bodies
    deepest = 0
    for level in range(1, max_depth + 1):
        if int(jnp.sum(tree.levels[level - 1].count >= 2)) > 0:
            deepest = level
    # adaptive node count: root + 4 children per >=2-count cell above
    nodes = 1
    for level in range(max_depth):
        nodes += 4 * int(jnp.sum(tree.levels[level].count >= 2))
    return {
        "nodes": nodes,
        "max_depth": deepest,
        "occupied_per_level": occupied,
    }


def tree_stats_3d(positions, masses, max_depth: int | None = None) -> dict:
    """Octree analogue of :func:`tree_stats` for 3D runs."""
    from ..ops.tree3d import R3_CNT, build_octree, default_max_depth3

    if max_depth is None:
        max_depth = default_max_depth3(positions.shape[0])
    tree = build_octree(positions, masses, max_depth=max_depth)
    counts = [lv[:, R3_CNT] for lv in tree.raw]
    occupied = [int(jnp.sum(c > 0)) for c in counts]
    deepest = 0
    for level in range(1, max_depth + 1):
        if int(jnp.sum(counts[level - 1] >= 2)) > 0:
            deepest = level
    nodes = 1
    for level in range(max_depth):
        nodes += 8 * int(jnp.sum(counts[level] >= 2))
    return {
        "nodes": nodes,
        "max_depth": deepest,
        "occupied_per_level": occupied,
    }
