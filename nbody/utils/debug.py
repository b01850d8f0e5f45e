"""Debug-mode validation (SURVEY.md 5.2/5.3).

The reference guards its hot paths with in-kernel printf checks (stack
overflow/underflow, project.cu:712-721) and host-side bounds checks
(project.cu:385-388, 411-414).  The equivalents here:

* argument validation before tracing (shapes, finiteness, ranges);
* ``checked_accel`` — wraps an acceleration fn with jax.experimental
  .checkify so NaN/Inf in the force pass surfaces as a real error
  instead of silently corrupting the trajectory;
* the traversal overflow flags (barnes_hut / bh_grouped
  ``return_diagnostics=True``) are the stack-guard analogue.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import checkify

from ..state import SimState


def validate_state(state: SimState) -> None:
    """Host-side argument validation (the loader-exception analogue,
    project.cu:110-161)."""
    n = state.n_bodies
    if n < 1:
        raise ValueError("need at least one body")
    if state.positions.shape != (n, 2) or state.velocities.shape != (n, 2):
        raise ValueError(
            f"shape mismatch: masses {state.masses.shape}, positions "
            f"{state.positions.shape}, velocities {state.velocities.shape}"
        )
    masses = np.asarray(state.masses)
    if not np.isfinite(masses).all():
        raise ValueError("non-finite masses")
    if (masses < 0).any():
        raise ValueError("negative masses")
    if not np.isfinite(np.asarray(state.positions)).all():
        raise ValueError("non-finite positions")
    if not np.isfinite(np.asarray(state.velocities)).all():
        raise ValueError("non-finite velocities")


def checked_accel(accel_fn):
    """Wrap an acceleration function with checkify NaN detection.

    Returns a function with the same signature whose first return value
    is the checkify error; call ``err.throw()`` (or keep it traced) to
    surface non-finite forces.
    """

    def inner(positions, masses):
        acc = accel_fn(positions, masses)
        checkify.check(
            jnp.isfinite(acc).all(), "non-finite acceleration in force pass"
        )
        return acc

    return checkify.checkify(inner, errors=checkify.float_checks)
