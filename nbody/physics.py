"""Force laws and the semi-implicit (symplectic) Euler integrator.

Reference semantics being replicated:

* Naive all-pairs force (main_approach_1.cpp:53-75):
      F_i = sum_{j != i} G * m_i * m_j / (d^2 * d) * (p_j - p_i)
  with *no* softening.

* Barnes-Hut accepted-node force (project.cu:651-658, 765-771):
      d   = sqrt(d2) + 1e-15        # softening added to the distance
      F  += G * m_i * M_node / d2 * (disp / d)
  i.e. the magnitude uses the *unsoftened* d2 while the direction is
  normalised by the softened distance.

* Integrator (project.cu:795-836, fused kernel updateAccVelPos):
      a = F / m ;  v += a * dt ;  p += v * dt
  — position update uses the already-updated velocity (semi-implicit /
  symplectic Euler; report formula p_{t+1} = p_t + v_{t+1} * dt).

Because a_i = F_i / m_i, the target mass cancels; all engines compute
accelerations directly (one multiply saved per pair, identical math up to
fp rounding — the f64 oracle keeps the reference factoring for parity).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from .state import SimState


def _pair_sum(w: jax.Array, disp: jax.Array) -> jax.Array:
    """sum_j w[i, j] * disp[i, j, :] at full precision: without HIGHEST a
    float32 contraction may run in TF32 on the GPU (about three decimal
    digits), and these paths are the references the kernels are held to."""
    return jnp.einsum(
        "ij,ijk->ik", w, disp, precision=jax.lax.Precision.HIGHEST
    )


def pair_accelerations_dense(
    positions: jax.Array,
    masses: jax.Array,
    g: float,
    softening: float = 0.0,
    mask_diagonal: bool = True,
) -> jax.Array:
    """O(N^2) accelerations with a dense [N, N] intermediate.

    Plain XLA path for small N and the test oracle for the tiled kernel
    (nbody.ops.allpairs).  Matches main_approach_1.cpp
    semantics when softening == 0 (diagonal masked instead of skipped).
    """
    # disp[i, j] = p_j - p_i  (force on i points toward j)
    disp = positions[None, :, :] - positions[:, None, :]  # [N, N, 2]
    d2 = jnp.sum(disp * disp, axis=-1)  # [N, N]
    n = positions.shape[0]
    valid = d2 > 0.0
    if mask_diagonal:
        eye = jnp.eye(n, dtype=bool)
        valid = valid & ~eye
    safe_d2 = jnp.where(valid, d2, 1.0)
    inv_d = jax.lax.rsqrt(safe_d2)
    if softening:
        d = safe_d2 * inv_d
        w = masses[None, :] / (safe_d2 * (d + softening))
    else:
        w = masses[None, :] * inv_d * inv_d * inv_d
    w = jnp.where(valid, w, 0.0)
    return g * _pair_sum(w, disp)


def pair_accelerations_chunked(
    positions: jax.Array,
    masses: jax.Array,
    g: float,
    softening: float = 0.0,
    chunk: int | None = None,
    targets: jax.Array | None = None,
) -> jax.Array:
    """O(N^2) accelerations without the dense [N, N] intermediate.

    Targets are processed ``chunk`` rows at a time under ``lax.map`` so
    peak memory is chunk x N instead of N x N — the precision-preserving
    path for float64 configs (the all-pairs kernel is f32-only; the
    reference is all-f64, project.cu:38-43), the CPU route of the
    all-pairs engines, and the plain XLA baseline the kernel is timed
    against.  ``targets`` (default: ``positions``) are the bodies
    accelerated by the sources (``positions``, ``masses``).  Same
    semantics as :func:`pair_accelerations_dense` (d2 > 0 guard excludes
    self-pairs and coincident padding).
    """
    tgt = positions if targets is None else targets
    n, dims = tgt.shape
    ns = positions.shape[0]
    if chunk is None:
        # bound the [chunk, Ns, D] intermediate to ~2^24 elements
        chunk = max(128, min(n, (1 << 24) // max(ns, 1)))
    chunk = min(chunk, n)
    pad = (-n) % chunk
    if pad:
        # far-away sentinel rows: results sliced off below
        tgt = jnp.concatenate(
            [tgt, jnp.full((pad, dims), 1e15, tgt.dtype)], axis=0
        )

    def block_fn(tblock):
        disp = positions[None, :, :] - tblock[:, None, :]  # [C, Ns, D]
        d2 = jnp.sum(disp * disp, axis=-1)
        valid = d2 > 0.0
        safe_d2 = jnp.where(valid, d2, 1.0)
        inv_d = jax.lax.rsqrt(safe_d2)
        if softening:
            d = safe_d2 * inv_d
            w = masses[None, :] / (safe_d2 * (d + softening))
        else:
            w = masses[None, :] * inv_d * inv_d * inv_d
        w = jnp.where(valid, w, 0.0)
        return g * _pair_sum(w, disp)

    acc = jax.lax.map(block_fn, tgt.reshape(-1, chunk, dims))
    return acc.reshape(-1, dims)[:n]


def integrate(
    state: SimState, accelerations: jax.Array, dt: float, overflow=None
) -> SimState:
    """Semi-implicit Euler: v' = v + a*dt ; p' = p + v'*dt (project.cu:819-836).

    ``overflow`` is the count of bodies whose traversal caps overflowed
    while computing ``accelerations`` (0 when the engine cannot
    overflow); it rides in the returned state as per-step telemetry."""
    new_v = state.velocities + accelerations * dt
    new_p = state.positions + new_v * dt
    if overflow is None:
        overflow = jnp.asarray(0, jnp.int32)
    return SimState(
        masses=state.masses,
        positions=new_p,
        velocities=new_v,
        time=state.time + jnp.asarray(dt, dtype=state.time.dtype),
        step=state.step + 1,
        overflow=jnp.asarray(overflow, jnp.int32),
    )


def kinetic_energy(state: SimState) -> jax.Array:
    v2 = jnp.sum(state.velocities**2, axis=-1)
    return 0.5 * jnp.sum(state.masses * v2)


def potential_energy(state: SimState, g: float) -> jax.Array:
    """Pairwise potential (diagnostic; O(N^2), use on small N)."""
    disp = state.positions[None, :, :] - state.positions[:, None, :]
    d = jnp.sqrt(jnp.sum(disp * disp, axis=-1))
    n = state.masses.shape[0]
    mm = state.masses[None, :] * state.masses[:, None]
    mask = ~jnp.eye(n, dtype=bool) & (d > 0)
    pe = jnp.where(mask, -g * mm / jnp.where(mask, d, 1.0), 0.0)
    return 0.5 * jnp.sum(pe)


def potential_per_body_chunked(
    positions: jax.Array,
    masses: jax.Array,
    g: float,
    chunk: int | None = None,
) -> jax.Array:
    """phi_i = sum_{j != i} -g*m_j/d_ij with a [chunk, N] intermediate
    (the large-N path of :func:`potential_energy_scalable`)."""
    n = positions.shape[0]
    dims = positions.shape[1]
    if chunk is None:
        chunk = max(128, min(n, (1 << 24) // max(n, 1)))
    chunk = min(chunk, n)
    pad = (-n) % chunk
    tgt = positions
    if pad:
        tgt = jnp.concatenate(
            [tgt, jnp.full((pad, dims), 1e15, tgt.dtype)], axis=0
        )

    def block_fn(tblock):
        disp = positions[None, :, :] - tblock[:, None, :]
        d2 = jnp.sum(disp * disp, axis=-1)
        valid = d2 > 0.0
        inv_d = jax.lax.rsqrt(jnp.where(valid, d2, 1.0))
        return jnp.sum(
            jnp.where(valid, -g * masses[None, :] * inv_d, 0.0), axis=-1
        )

    phi = jax.lax.map(block_fn, tgt.reshape(-1, chunk, dims))
    return phi.reshape(-1)[:n]


def potential_energy_scalable(state: SimState, g: float) -> jax.Array:
    """Pairwise potential energy at any N.

    Tiny N -> the dense diagnostic; otherwise the chunked XLA path
    (bounded memory, preserves f64).  This is what keeps the metrics CSV's
    ``total_energy`` finite at N=64K..1M instead of NaN-ing past a
    dense-intermediate cutoff.
    """
    n = state.masses.shape[0]
    if n <= 4096:
        return potential_energy(state, g)
    phi = potential_per_body_chunked(state.positions, state.masses, g)
    return 0.5 * jnp.sum(state.masses * phi)


def total_momentum(state: SimState) -> jax.Array:
    return jnp.sum(state.masses[:, None] * state.velocities, axis=0)
