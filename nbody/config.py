"""Runtime configuration for the N-body framework.

The reference configures itself with three compile-time ``#define``s
(``N_BODIES`` / ``N_THREADS`` / ``N_SIMULATIONS``, reference project.cu:1-11)
plus ``const`` globals edited in source (physics constants project.cu:27-35,
tree constants project.cu:60-62) and mode selection by commenting lines in
``main`` (project.cu:1061-1066).  Here every knob is a runtime dataclass
field, so sweeps (the reference's first/second_scaling_script.sh) never
recompile anything.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# ---------------------------------------------------------------------------
# Physics constants (reference project.cu:27-35, main_approach_1.cpp:11-21)
# ---------------------------------------------------------------------------
G_DEFAULT = 6.67e-11
N_DIM = 2
DT_DEFAULT = 1.0

# Init ranges of the main artifact (project.cu:30-35).  main_approach_*.cpp
# use a wider mass range (1e-6 .. 1e6, main_approach_1.cpp:16-17).
LOWER_M = 1e-1
HIGHER_M = 5e-1
LOWER_P = -1e-1
HIGHER_P = 1e-1
LOWER_V = -1e-4
HIGHER_V = 1e-4

# ---------------------------------------------------------------------------
# Barnes-Hut constants (reference project.cu:60-62)
# ---------------------------------------------------------------------------
THETA_DEFAULT = 0.5
# The reference's QUADTREE_MAX_DEPTH=10 counts the root as depth 1 (QuadInsert
# is seeded with current_depth=1, project.cu:587; aggregation triggers when
# inserting into a node at current_depth >= 10, project.cu:360).  In 0-based
# dump terms (TraverseTreeToFile starts at depth 0, project.cu:505) the
# deepest node therefore sits at depth 9, i.e. the finest subdivision grid is
# 2**9 = 512 cells per axis and the complete tree has (4**10 - 1) / 3 =
# 349,525 nodes == the reference's QUADTREE_MAX_SIZE (project.cu:62).
MAX_DEPTH_DEFAULT = 9
# Softening added to the *distance* (not distance**2) in the Barnes-Hut
# force (project.cu:634/748: distance = sqrt(d2) + 1e-15).  The naive engine
# (main_approach_1.cpp:66-67) uses no softening.
BH_SOFTENING = 1e-15
# Nodes with total mass below this are skipped during traversal
# (project.cu:617/731: ``if (nodeMass <= 1e-15) continue``).
MASS_SKIP_THRESHOLD = 1e-15
# Bounding-box pad fraction (project.cu:558: padFraction = 0.1).
ROOT_PAD_FRACTION = 0.1


@dataclasses.dataclass(frozen=True)
class InitRanges:
    """Random-initialisation ranges (reference project.cu:30-35).

    Masses are log-uniform (generateLogRandom, project.cu:99-101); positions
    and velocities are uniform (generateRandom, project.cu:80-82).
    """

    lower_m: float = LOWER_M
    higher_m: float = HIGHER_M
    lower_p: float = LOWER_P
    higher_p: float = HIGHER_P
    lower_v: float = LOWER_V
    higher_v: float = HIGHER_V


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for multi-chip runs.

    The reference is single-process / single-GPU; its only distribution axis
    is threads-over-bodies (grid-stride loop, project.cu:703).  Here the
    first-class axes are:

    * ``dp``  — bodies sharded over devices, positions all-gathered per step
      (the strong/weak-scaling analogue of first/second_scaling_script.sh).
    * ring / 2-D interaction sharding are selected per-engine, see
      :mod:`nbody.parallel`.
    """

    dp: int = 1
    axis_name: str = "dp"


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Every knob of the reference, runtime-switchable."""

    # Problem size / schedule (reference #defines, project.cu:1-11).
    n_bodies: int = 1024
    n_steps: int = 10
    dt: float = DT_DEFAULT
    g: float = G_DEFAULT

    # Spatial dimensionality.  The reference is 2D-only (N_DIM=2,
    # project.cu:28); 3 enables the octree generalisation its report
    # names (project_report.pdf p.8) — see ops/tree3d, ops/bh3d.
    n_dim: int = 2

    # Engine selection (reference: pick one of three programs / comment lines
    # in main, README.md:14-18).
    engine: str = "allpairs"  # "naive" | "allpairs" | "barnes_hut"

    # Barnes-Hut knobs (project.cu:60-62).  ``max_depth=None`` = auto:
    # the reference's QUADTREE_MAX_DEPTH=10 (== our 0-based 9) in 2D, a
    # density-derived depth in 3D (ops.tree3d.default_max_depth3 —
    # 8^9 octree leaves would be 134M cells).  An explicit value is
    # always honored, including 9/32 (no sentinel aliasing).
    theta: float = THETA_DEFAULT
    max_depth: Optional[int] = None
    softening: float = BH_SOFTENING

    # Precision policy.  The reference is all-fp64; the default is f32
    # with the f64 oracle used for parity budgets (SURVEY.md section 7).
    dtype: str = "float32"  # "float32" | "float64" | "bfloat16"
    # Kahan-compensated accumulation across source tiles in the all-pairs
    # kernel (SURVEY 7 "hard parts"; pushes the f32 accumulation error
    # floor).
    compensated: bool = False

    # RNG (reference seeds std::rand with time(0), project.cu:1051; we use a
    # counter-based JAX PRNG for reproducibility).
    seed: int = 0
    init: InitRanges = dataclasses.field(default_factory=InitRanges)
    # "uniform" (the reference's distribution) or "blobs" (two dense
    # Gaussian clusters — the collapsed worst case the traversal caps
    # are calibrated against, see rng.random_state / PERF.md)
    init_mode: str = "uniform"

    # All-pairs kernel tiling (the analogue of the reference's block-size
    # choice, project.cu:163-217).  None = the kernel's defaults, chosen on
    # the card (ops.allpairs.TARGET_BLOCK / SOURCE_BLOCK).
    target_block: Optional[int] = None
    source_block: Optional[int] = None

    # Barnes-Hut traversal frontier capacity (the analogue of the
    # reference's fixed in-register stack of 3*MAX_DEPTH+1 ints,
    # project.cu:708).  None = auto: the grouped engine derives a
    # per-level schedule from measured demand (ops.bh_grouped
    # frontier_schedule); the exact engine uses 256.
    frontier_cap: Optional[int] = None

    # Barnes-Hut engine mode: "grouped" (Morton-sorted body groups share a
    # conservative traversal + dense evaluation; the fast path) or
    # "exact" (per-body frontier traversal, bit-faithful to the reference's
    # per-thread DFS; used for parity testing and small N).  None caps =
    # auto from ops.bh_grouped.cap_defaults (measured-demand calibration).
    bh_mode: str = "grouped"
    # None = auto Morton group size: 2048 in 2D (bh_grouped
    # DEFAULT_GROUP_SIZE); 3D is N-gated — 4096 in [256K, 768K), 2048
    # elsewhere (ops.bh3d.default_group_size3).  The gate predates the GPU
    # port and will be decided again on the card (ROADMAP Speed #4).
    group_size: Optional[int] = None
    list_cap: Optional[int] = None
    direct_cap: Optional[int] = None
    # None = auto: 32 in 2D; N-aware in 3D (ops.bh3d
    # direct_cell_max_default).  Explicit values are always honored.
    direct_cell_max: Optional[int] = None
    direct_body_cap: Optional[int] = None
    group_chunk: int = 32
    # 3D list-collection traversal (ops.bh3d): None/"auto" = the
    # window-stencil walk (ops/collect_dense3.py — dynamic-slice spatial
    # windows + spill, no per-level gathers) for N >= 256K, the gather
    # frontier walk below; "gather" / "dense" force.  The N-gate predates
    # the GPU port and will be decided again on the card (ROADMAP Speed #4).
    # The adaptive retry always falls back to the gather walk (4x caps
    # widen frontiers, not windows).
    collect3: Optional[str] = None
    # Adaptive cap retry (contract loop, barnes_hut): when a step's
    # traversal caps overflow, recompute that step from the pre-step
    # state with every cap at 4x (lazily compiled on first overflow) —
    # the calibrated caps stay the fast path, pathological states get
    # correctness instead of dropped interactions.
    adaptive_caps: bool = True

    # Parallelism.
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    # Per-card device-memory budget (bytes) for the mode="auto"
    # grouped-vs-sharded Barnes-Hut gate (parallel/memory.py — the
    # reference's 48KB shared-memory gate at device-memory scale,
    # project.cu:971-974).  None = the card's own limit
    # (memory_stats()["bytes_limit"]); the CLI --hbm-gb flag maps onto
    # this field.
    hbm_bytes: Optional[int] = None

    # I/O toggles (reference: save init files project.cu:236-246, positions
    # every step project.cu:909, tree dumps first/last step project.cu:962).
    save_positions: bool = False
    save_tree_dumps: bool = False
    output_dir: str = "."

    # Checkpoint / resume (superset of the reference's init-file persistence,
    # SURVEY.md section 5.4).
    checkpoint_every: int = 0  # 0 = disabled
    checkpoint_path: Optional[str] = None

    # Observability (SURVEY.md 5.5): per-step conserved-quantity / tree
    # statistics CSV, opt-in by filename.  Tree statistics (node count /
    # max occupied depth, observations.txt:59-65) rebuild the pyramid once
    # per recorded step; opt out for very large N with metrics_tree=False.
    metrics_csv: Optional[str] = None
    metrics_tree: bool = True

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    @property
    def resolved_max_depth(self) -> int:
        """``max_depth`` with the None-auto resolved (2D: the reference
        default 9; 3D: density-derived via tree3d.default_max_depth3)."""
        if self.max_depth is not None:
            return self.max_depth
        if self.n_dim == 3:
            from .ops.tree3d import default_max_depth3

            return default_max_depth3(self.n_bodies)
        return MAX_DEPTH_DEFAULT

    @property
    def resolved_direct_cell_max(self) -> Optional[int]:
        """``direct_cell_max`` with the 2D None-auto resolved to 32; in
        3D None passes through (the engine resolves its own N-aware
        threshold, ops.bh3d.direct_cell_max_default)."""
        if self.direct_cell_max is not None or self.n_dim == 3:
            return self.direct_cell_max
        return 32

    @property
    def n_cells_finest(self) -> int:
        # cells per axis at the deepest level
        return 1 << self.resolved_max_depth

    @property
    def n_tree_nodes(self) -> int:
        """Complete-tree node count; equals the reference QUADTREE_MAX_SIZE
        ((4**(max_depth+1) - 1) / 3, project.cu:62) for max_depth=9."""
        return (4 ** (self.resolved_max_depth + 1) - 1) // 3

    def jnp_dtype(self):
        import jax.numpy as jnp

        return {
            "float32": jnp.float32,
            "float64": jnp.float64,
            "bfloat16": jnp.bfloat16,
        }[self.dtype]
