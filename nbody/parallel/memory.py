"""Per-card memory model for the multi-card Barnes-Hut modes + auto gate.

The reference stages its tree into fast memory only when an analytic
byte count says it fits: ``sharedMemSize = treeBytes <= 48KB ? bytes : 0``
(project.cu:971-974) — the gate itself is host-side arithmetic, not a
measurement.  This module is the same decision logic at HBM scale: an
analytic per-card byte model of what each Barnes-Hut distribution mode
materializes, driving ``make_sharded_step(mode="auto")``:

* ``dp_barnes_hut_grouped`` (2D) / ``..._grouped3`` (3D) — all_gathers
  the full body cloud per chip: source bytes O(N), fastest when it fits
  (no halo exchange, no window placement).
* ``dp_barnes_hut_sharded`` / ``..._sharded3`` — 3-slab ppermute window:
  source bytes O(N/devices), the weak-scaling mode for body counts one
  chip cannot replicate (the reference report's named blocker,
  project_report.pdf p.7).

Both replicate the implicit pyramid (O(4^depth) / O(8^depth) — bounded
by the reference's own QUADTREE_MAX_SIZE planning constant,
project.cu:62), so the tree term is common and the gate decides on the
source term vs the per-card device-memory budget.
"""

from __future__ import annotations

from ..config import SimConfig

# Sources may take this slice of the card's memory; the lion's share stays
# with the evaluation temporaries (group frontiers, direct lists), the
# integrator state and XLA's own workspace.
SOURCE_BUDGET_FRACTION = 0.25

_F32 = 4

# f32 fields materialized per tree cell per level:
# 2D: packed raw rows [4^l, 8] + finished TreeLevel (mass/comx/comy/count)
# 3D: packed raw rows [8^l, 16] (no separate finished level)
_TREE_FIELDS = {2: 8 + 4, 3: 16}
# f32 per body a mode's source window carries (coords + g*mass; the 2D
# sharded window also rides the Morton code alongside)
_ROW_FIELDS = {2: 4, 3: 5}


def tree_bytes(config: SimConfig) -> int:
    """Replicated implicit-pyramid bytes per chip (all levels, root..depth)."""
    dim = getattr(config, "n_dim", 2)
    branch = 2**dim
    depth = config.resolved_max_depth
    cells = (branch ** (depth + 1) - 1) // (branch - 1)
    return cells * _TREE_FIELDS[dim] * _F32


def source_bytes(config: SimConfig, n_devices: int, mode: str) -> int:
    """Per-chip *source-body* bytes a mode materializes (excl. tree).

    grouped: the all_gathered cloud, N rows.
    sharded: the 3-slab window [left | own | right] plus its sorted copy
    (the sort cannot alias its input), i.e. 2 * 3 * N/devices rows —
    still O(N/devices) by construction.
    """
    dim = getattr(config, "n_dim", 2)
    rows = _ROW_FIELDS[dim] * _F32
    n = config.n_bodies
    if "sharded" in mode:
        slab = -(-n // n_devices)  # ceil
        window = slab if n_devices == 1 else (2 if n_devices == 2 else 3) * slab
        return 2 * window * rows
    return n * rows


def per_chip_bytes(config: SimConfig, n_devices: int, mode: str) -> int:
    """Total modeled per-chip bytes for a Barnes-Hut mode: tree + sources."""
    return tree_bytes(config) + source_bytes(config, n_devices, mode)


def device_memory_bytes() -> int:
    """Memory JAX may use on the first device (``bytes_limit``).

    Raises on a device that reports no memory statistics (the CPU): the
    gate then needs an explicit ``hbm_bytes``."""
    import jax

    stats = jax.devices()[0].memory_stats()
    if not stats or "bytes_limit" not in stats:
        raise ValueError(
            f"{jax.devices()[0].device_kind!r} reports no memory limit; "
            "pass hbm_bytes (SimConfig.hbm_bytes / --hbm-gb) to the "
            "Barnes-Hut mode gate"
        )
    return int(stats["bytes_limit"])


def choose_bh_mode(
    config: SimConfig,
    n_devices: int,
    hbm_bytes: int | None = None,
    verbose: bool = False,
) -> str:
    """Pick grouped vs sharded Barnes-Hut from the HBM-fit model.

    Grouped wins whenever the replicated cloud fits the source budget
    (it is faster: no halo ppermutes, no window placement); sharded is
    the fallback that keeps per-chip sources O(N/devices).

    ``hbm_bytes=None`` resolves from ``config.hbm_bytes`` (set via the
    CLI ``--hbm-gb`` or the library config), then from the card itself
    (:func:`device_memory_bytes`) — so library callers of
    ``make_sharded_step(mode="auto")`` honor the same knob as the CLI.
    """
    if hbm_bytes is None:
        hbm_bytes = config.hbm_bytes or device_memory_bytes()
    dim = getattr(config, "n_dim", 2)
    suffix = "3" if dim == 3 else ""
    budget = int(hbm_bytes * SOURCE_BUDGET_FRACTION)
    grouped = per_chip_bytes(config, n_devices, "grouped")
    mode = (
        f"dp_barnes_hut_grouped{suffix}"
        if grouped <= budget
        else f"dp_barnes_hut_sharded{suffix}"
    )
    if verbose:
        import sys

        sharded = per_chip_bytes(config, n_devices, "sharded")
        print(
            f"memory gate: grouped {grouped/1e6:.1f} MB vs sharded "
            f"{sharded/1e6:.1f} MB per card (budget {budget/1e6:.0f} MB, "
            f"{n_devices} devices) -> {mode}",
            file=sys.stderr,
        )
    return mode


# ---------------------------------------------------------------------------
# Communication model (bytes/step/chip per mode)
#
# The reference quantifies its per-step staging traffic — the tree H2D
# every step (project.cu:968) and positions D2H every step
# (project.cu:1010), measured in project_report.pdf p.22.  Our
# equivalents are collectives between the cards; this model makes the docstring
# claims of parallel/steps.py (grouped = O(N) all_gather, sharded =
# O(N/devices + tree)) *tested arithmetic*: `collective_inventory`
# enumerates every collective one step issues with its per-chip operand
# payload (tests assert it against the traced jaxpr's collective
# operand shapes), and `comm_bytes_per_step` converts payloads into
# wire bytes sent per chip under standard ring algorithms.
# ---------------------------------------------------------------------------

_I32 = 4

# packed raw leaf-table fields that ride the pyramid psum
# (ops/tree.leaf_raw -> [4^d, 8] f32; ops/tree3d.leaf_raw_3d -> [8^d, 16])
_RAW_FIELDS = {2: 8, 3: 16}


def _leaf_psum_bytes(config: SimConfig) -> int:
    """Payload of the ONE leaf-table psum that replicates the pyramid."""
    dim = getattr(config, "n_dim", 2)
    depth = config.resolved_max_depth
    return (2**dim) ** depth * _RAW_FIELDS[dim] * _F32


def _slab(config: SimConfig, n_devices: int) -> int:
    """Per-chip body-slab length (bodies shard evenly over dp)."""
    return -(-config.n_bodies // n_devices)  # ceil


def collective_inventory(
    config: SimConfig, n_devices: int, mode: str, sp: int = 1
) -> list:
    """Every collective one sharded step issues, as ``(op, payload)``
    pairs where ``payload`` is the per-chip operand bytes — matching the
    traced jaxpr's collective operand shapes one-to-one (asserted by
    tests/test_comm_model.py).  For ``dp2d_allpairs`` ``n_devices`` is
    the dp axis size and ``sp`` the source axis (targets shard over dp;
    sources stripe over sp).

    Scalar control-plane reductions (root bounds pmin/pmax, the psum'd
    overflow count) are included so the inventory is complete, but they
    are 4-byte payloads — the story is the array terms.
    """
    dim = getattr(config, "n_dim", 2)
    s = _slab(config, n_devices)
    pos = s * dim * _F32
    mass = s * _F32
    inv: list = []
    if mode == "dp_allpairs":
        inv += [("all_gather", pos), ("all_gather", mass)]
    elif mode == "ring_allpairs":
        inv += [("ppermute", pos), ("ppermute", mass)] * (n_devices - 1)
    elif mode == "dp2d_allpairs":
        # bodies shard over dp only; the gather runs once per sp replica
        # (counted once per chip); the partial-acc psum rides sp
        inv += [("all_gather", pos), ("all_gather", mass)]
        inv += [("psum", s * dim * _F32)]
    elif mode == "dp_barnes_hut":
        inv += [("pmin", _F32), ("pmax", _F32)] * dim
        inv += [("psum", _leaf_psum_bytes(config))]
        inv += [("psum", _I32)]  # overflow count
    elif mode in ("dp_barnes_hut_grouped", "dp_barnes_hut_grouped3"):
        inv += [("all_gather", pos), ("all_gather", mass)]
        inv += [("psum", _I32)]
    elif mode in ("dp_barnes_hut_sharded", "dp_barnes_hut_sharded3"):
        inv += [("pmin", _F32), ("pmax", _F32)] * dim
        inv += [("psum", _leaf_psum_bytes(config))]
        # halo slabs: own rows [slab, dim+1] f32 + codes [slab] i32,
        # once per neighbour (two for n_dev > 2, one for n_dev == 2)
        halos = 0 if n_devices == 1 else (1 if n_devices == 2 else 2)
        inv += [
            ("ppermute", s * (dim + 1) * _F32),
            ("ppermute", s * _I32),
        ] * halos
        inv += [("psum", _I32)]
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return inv


def comm_bytes_per_step(
    config: SimConfig, n_devices: int, mode: str, sp: int = 1
) -> int:
    """Wire bytes SENT per chip per step under ring algorithms:
    all_gather of slab ``s`` over D sends ``(D-1)*s``; psum of payload
    ``p`` sends ``2*p*(D-1)/D`` (reduce-scatter + all-gather); ppermute
    sends its payload once; pmin/pmax modeled as scalar psums.

    This is the number the sharded design's O(N/devices + tree) claim
    is about: grouped's all_gather term grows with N while sharded's
    ppermute term is N/devices and its psum term is the (N-independent)
    leaf table."""
    d = max(n_devices, 1)
    if mode == "dp2d_allpairs":
        sp = max(sp, 1)
        total = 0.0
        for op, p in collective_inventory(config, n_devices, mode, sp):
            if op == "all_gather":
                total += (d - 1) * p
            elif op == "psum":
                total += 2 * p * (sp - 1) / sp
        return int(total)
    total = 0.0
    for op, p in collective_inventory(config, n_devices, mode):
        if op == "all_gather":
            total += (d - 1) * p
        elif op == "ppermute":
            total += p
        else:  # psum / pmin / pmax
            total += 2 * p * (d - 1) / d
    return int(total)
