"""Device meshes and state sharding.

The reference is single-process / single-GPU; its only scaling axis is
threads-over-bodies (grid-stride loop, project.cu:703) swept by recompiling
(first/second_scaling_script.sh).  Here the equivalents are jax.sharding
meshes: bodies shard over a 1-D "dp" axis (strong/weak scaling,
BASELINE.json configs 4-5); a 2-D ("dp", "sp") mesh shards the O(N^2)
interaction matrix target x source (the tensor-parallel analogue,
SURVEY.md section 2.5).  Collectives are jax.lax primitives, which XLA
hands to NCCL (NVLink between the cards of one host).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..state import SimState


def make_mesh(
    n_devices: Optional[int] = None, axis_name: str = "dp"
) -> Mesh:
    """1-D body-sharding mesh over the first n_devices devices."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def make_mesh_2d(
    dp: int, sp: int, axis_names: Tuple[str, str] = ("dp", "sp")
) -> Mesh:
    """2-D interaction-sharding mesh (targets over dp, sources over sp)."""
    devices = np.asarray(jax.devices()[: dp * sp]).reshape(dp, sp)
    return Mesh(devices, axis_names)


def shard_state(state: SimState, mesh: Mesh, axis_name: str = "dp") -> SimState:
    """Place body arrays with bodies sharded over the mesh's dp axis
    (time/step replicated).  N must divide evenly by the axis size."""
    n = state.n_bodies
    dp = mesh.shape[axis_name]
    if n % dp != 0:
        raise ValueError(
            f"n_bodies={n} not divisible by mesh axis {axis_name}={dp}; "
            "pad the state (see pad_state_to)."
        )
    body = NamedSharding(mesh, P(axis_name))
    body2 = NamedSharding(mesh, P(axis_name, None))
    rep = NamedSharding(mesh, P())
    return SimState(
        masses=jax.device_put(state.masses, body),
        positions=jax.device_put(state.positions, body2),
        velocities=jax.device_put(state.velocities, body2),
        time=jax.device_put(state.time, rep),
        step=jax.device_put(state.step, rep),
        overflow=jax.device_put(state.overflow, rep),
    )
