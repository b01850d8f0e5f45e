"""Force engines: naive dense, tiled all-pairs kernel, Barnes-Hut.

The reference ships three progressively optimized engines selected by
recompiling / editing main (README.md:14-18); here they are runtime-
selectable acceleration functions with one signature:

    accel_fn(positions [N,2], masses [N]) -> accelerations [N,2]
"""

from __future__ import annotations

from typing import Callable

from ..config import SimConfig
from ..device import kernel_route
from ..physics import pair_accelerations_chunked, pair_accelerations_dense


def resolved_caps(config: SimConfig) -> dict:
    """The traversal caps the barnes_hut engine will actually use —
    explicit config values where set, the demand-calibrated defaults
    otherwise.  Basis for the adaptive-caps retry (simulation.py):
    scaling these uniformly scales the whole frontier schedule too
    (frontier_schedule derives every level from frontier_cap)."""
    n = config.n_bodies
    if getattr(config, "n_dim", 2) == 3:
        from ..ops.bh3d import cap_defaults_3d

        d = cap_defaults_3d(n)
    else:
        from ..ops.bh_grouped import DEFAULT_GROUP_SIZE, cap_defaults

        d = cap_defaults(config.group_size or DEFAULT_GROUP_SIZE, n)
    return dict(
        frontier_cap=config.frontier_cap or d["frontier_cap"],
        list_cap=config.list_cap or d["list_cap"],
        direct_cap=config.direct_cap or d["direct_cap"],
        direct_body_cap=config.direct_body_cap or d["direct_body_cap"],
    )


def make_accel_fn(config: SimConfig, return_diagnostics: bool = False) -> Callable:
    """Build the configured engine's acceleration function.

    With ``return_diagnostics`` the function returns ``(acc, overflow)``
    where ``overflow`` is a per-body bool marking traversal/list-cap
    overflow (the stack-guard analogue, reference project.cu:712-721).
    The all-pairs engines cannot overflow and return all-False.
    """
    engine = config.engine
    g = config.g

    if engine == "naive":
        # main_approach_1.cpp semantics: dense O(N^2), no softening.
        def accel(positions, masses):
            acc = pair_accelerations_dense(
                positions, masses, g=g, softening=0.0
            )
            if return_diagnostics:
                import jax.numpy as jnp

                return acc, jnp.zeros((positions.shape[0],), bool)
            return acc

        return accel

    if engine == "allpairs":
        from ..ops.allpairs import allpairs_accelerations

        softening = 0.0  # naive-pair semantics (main_approach_1.cpp:66-67)
        # the kernel is f32-only; float64 configs keep full precision on
        # the chunked XLA path (the reference is all-f64, project.cu:38-43)
        use_kernel = (
            kernel_route() == "gpu" and config.dtype != "float64"
        )

        def accel(positions, masses):
            n = positions.shape[0]
            if n < 512:
                # tiny problems: the dense XLA path beats kernel overheads
                acc = pair_accelerations_dense(
                    positions, masses, g=g, softening=softening
                )
            elif use_kernel:
                acc = allpairs_accelerations(
                    positions, masses, g=g, softening=softening,
                    target_block=config.target_block,
                    source_block=config.source_block,
                    compensated=config.compensated,
                )
            else:
                acc = pair_accelerations_chunked(
                    positions, masses, g=g, softening=softening
                )
            if return_diagnostics:
                import jax.numpy as jnp

                return acc, jnp.zeros((n,), bool)
            return acc

        return accel

    if engine == "barnes_hut":
        if getattr(config, "n_dim", 2) == 3:
            if config.bh_mode == "exact":
                raise ValueError(
                    "bh_mode='exact' is 2D-only (it mirrors the "
                    "reference's per-body quadtree DFS); 3D Barnes-Hut "
                    "uses the grouped octree engine (bh_mode='grouped')"
                )
            from ..ops.bh3d import bh3_accelerations_grouped

            # None-auto resolution (2D's 9 would be 8^9 = 134M octree
            # leaves); explicit user values are always honored.
            depth3 = config.resolved_max_depth
            dcm3 = config.resolved_direct_cell_max

            def accel(positions, masses):
                return bh3_accelerations_grouped(
                    positions,
                    masses,
                    g=g,
                    theta=config.theta,
                    max_depth=depth3,
                    softening=config.softening,
                    group_size=config.group_size,
                    frontier_cap=config.frontier_cap,
                    list_cap=config.list_cap,
                    direct_cap=config.direct_cap,
                    direct_cell_max=dcm3,
                    direct_body_cap=config.direct_body_cap,
                    group_chunk=config.group_chunk,
                    return_diagnostics=return_diagnostics,
                    collect=config.collect3,
                )

            return accel

        if config.bh_mode == "exact":
            from ..ops.barnes_hut import bh_accelerations

            def accel(positions, masses):
                return bh_accelerations(
                    positions,
                    masses,
                    g=g,
                    theta=config.theta,
                    max_depth=config.resolved_max_depth,
                    softening=config.softening,
                    frontier_cap=config.frontier_cap or 256,
                    return_diagnostics=return_diagnostics,
                )

            return accel

        from ..ops.bh_grouped import bh_accelerations_grouped

        def accel(positions, masses):
            return bh_accelerations_grouped(
                positions,
                masses,
                g=g,
                theta=config.theta,
                max_depth=config.resolved_max_depth,
                softening=config.softening,
                group_size=config.group_size,
                frontier_cap=config.frontier_cap,
                list_cap=config.list_cap,
                direct_cap=config.direct_cap,
                direct_cell_max=config.resolved_direct_cell_max,
                direct_body_cap=config.direct_body_cap,
                group_chunk=config.group_chunk,
                return_diagnostics=return_diagnostics,
            )

        return accel

    raise ValueError(f"unknown engine {engine!r}")
