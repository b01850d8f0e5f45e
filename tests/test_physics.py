"""Integrator and dense force-law semantics vs the f64 oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody import SimConfig, integrate, make_state, total_momentum
from nbody.models import oracle
from nbody.physics import pair_accelerations_dense

G = 6.67e-11


def test_two_body_symmetry():
    """Equal masses: equal and opposite accelerations (Newton's third law)."""
    masses = np.array([2.0, 2.0])
    positions = np.array([[0.0, 0.0], [1.0, 0.0]])
    acc = np.asarray(
        pair_accelerations_dense(jnp.asarray(positions), jnp.asarray(masses), g=G)
    )
    np.testing.assert_allclose(acc[0], -acc[1], rtol=1e-6)
    assert acc[0, 0] > 0  # body 0 pulled toward body 1
    np.testing.assert_allclose(acc[0, 0], G * 2.0, rtol=1e-5)


def test_dense_matches_oracle(small_cloud):
    masses, positions, velocities = small_cloud
    expected = oracle.naive_accelerations(positions, masses, g=G)
    got = np.asarray(
        pair_accelerations_dense(
            jnp.asarray(positions, jnp.float32),
            jnp.asarray(masses, jnp.float32),
            g=G,
        )
    )
    np.testing.assert_allclose(got, expected, rtol=2e-4, atol=1e-18)


def test_semi_implicit_euler_order():
    """p' must use the *updated* velocity (project.cu:819-836 fused order)."""
    state = make_state(
        masses=np.array([1.0]),
        positions=np.array([[0.0, 0.0]]),
        velocities=np.array([[1.0, 0.0]]),
    )
    acc = jnp.array([[0.5, 0.0]])
    out = integrate(state, acc, dt=2.0)
    # v' = 1 + 0.5*2 = 2 ; p' = 0 + 2*2 = 4 (explicit Euler would give 2)
    np.testing.assert_allclose(np.asarray(out.velocities), [[2.0, 0.0]])
    np.testing.assert_allclose(np.asarray(out.positions), [[4.0, 0.0]])
    assert float(out.time) == 2.0
    assert int(out.step) == 1


def test_trajectory_matches_oracle(small_cloud):
    """Multi-step f32 trajectory within budget of the f64 oracle."""
    masses, positions, velocities = small_cloud
    n_steps = 20
    traj = oracle.simulate(
        positions, velocities, masses, n_steps, dt=1.0, g=G, engine="naive"
    )
    state = make_state(masses, positions, velocities)
    for _ in range(n_steps):
        acc = pair_accelerations_dense(state.positions, state.masses, g=G)
        state = integrate(state, acc, dt=1.0)
    scale = np.abs(traj[-1]).max()
    np.testing.assert_allclose(
        np.asarray(state.positions), traj[-1], atol=1e-3 * scale
    )


def test_momentum_conservation(small_cloud):
    """Pairwise symmetric forces conserve total momentum."""
    masses, positions, velocities = small_cloud
    state = make_state(masses, positions, velocities, dtype=jnp.float32)
    p0 = np.asarray(total_momentum(state))
    for _ in range(10):
        acc = pair_accelerations_dense(state.positions, state.masses, g=G)
        state = integrate(state, acc, dt=1.0)
    p1 = np.asarray(total_momentum(state))
    scale = float(np.sum(masses * np.abs(velocities).max()))
    np.testing.assert_allclose(p1, p0, atol=1e-6 * scale)


def test_float64_requires_x64_flag():
    """dtype='float64' must fail loudly rather than silently downcast
    (the reference is all-fp64, project.cu:38-43)."""
    import jax

    from nbody.models.simulation import Simulation

    if jax.config.jax_enable_x64:
        pytest.skip("x64 enabled in this environment")
    with pytest.raises(RuntimeError, match="float64"):
        Simulation(SimConfig(n_bodies=8, dtype="float64"))


def test_bfloat16_smoke():
    """bf16 runs end-to-end (accuracy is reduced; it exists for memory-
    bound exploration, not parity)."""
    from nbody.models.simulation import Simulation

    sim = Simulation(SimConfig(n_bodies=32, n_steps=2, engine="naive",
                               dtype="bfloat16"))
    state, _ = sim.run_contract()
    assert np.isfinite(np.asarray(state.positions, dtype=np.float32)).all()
