"""Barnes-Hut traversal vs the f64 oracle (the reference's own
verification method: engine-vs-engine comparison, checkEqual
project.cu:1027-1047)."""

import jax.numpy as jnp
import numpy as np
import pytest

from nbody.models import oracle
from nbody.ops.barnes_hut import bh_accelerations
from nbody.physics import pair_accelerations_dense

G = 6.67e-11


def _cloud(n, seed=11):
    rng = np.random.default_rng(seed)
    masses = (10 ** rng.uniform(-1, np.log10(0.5), n)).astype(np.float32)
    positions = rng.uniform(-0.1, 0.1, (n, 2)).astype(np.float32)
    return masses, positions


@pytest.mark.parametrize(
    "theta",
    [pytest.param(0.3, marks=pytest.mark.slow), 0.5,
     pytest.param(0.8, marks=pytest.mark.slow)],
)
def test_matches_oracle(theta):
    masses, positions = _cloud(600)
    want = oracle.bh_accelerations(positions, masses, g=G, theta=theta)
    got = np.asarray(
        bh_accelerations(
            jnp.asarray(positions),
            jnp.asarray(masses),
            g=G,
            theta=theta,
            body_chunk=1024,
        )
    )
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=2e-4 * scale)


def test_theta_zero_converges_to_allpairs():
    """theta -> 0 opens everything: must equal softened all-pairs when the
    frontier fits (N < frontier_cap)."""
    masses, positions = _cloud(150, seed=3)
    ap = np.asarray(
        pair_accelerations_dense(
            jnp.asarray(positions), jnp.asarray(masses), g=G, softening=1e-15
        )
    )
    got, ovf = bh_accelerations(
        jnp.asarray(positions),
        jnp.asarray(masses),
        g=G,
        theta=1e-9,
        body_chunk=256,
        return_diagnostics=True,
    )
    assert int(np.asarray(ovf).sum()) == 0
    scale = np.abs(ap).max()
    np.testing.assert_allclose(np.asarray(got), ap, atol=1e-5 * scale)


@pytest.mark.slow
def test_overflow_flag_fires():
    """When the frontier cannot hold the open set, the per-body overflow
    flag must report it (the analogue of the reference's in-kernel stack
    guard printfs, project.cu:712-721) instead of silently dropping
    interactions."""
    masses, positions = _cloud(800)
    _, ovf = bh_accelerations(
        jnp.asarray(positions),
        jnp.asarray(masses),
        g=G,
        theta=1e-6,
        body_chunk=1024,
        return_diagnostics=True,
    )
    assert int(np.asarray(ovf).sum()) > 0


def test_max_depth_aggregation_self_interaction():
    """Reference quirk preserved: bodies co-located in one max-depth cell
    feel their own aggregate (PARTICLE_INDEX=-1 defeats the self-skip,
    project.cu:378), while a *single* body at max depth skips itself via
    the negative encoding (project.cu:376/646)."""
    # Two bodies in the same finest cell + one far body.  With max_depth=2
    # the finest grid is 4x4, so the close pair shares a cell.
    masses = np.array([1.0, 1.0, 1.0], dtype=np.float32)
    positions = np.array(
        [[0.01, 0.01], [0.0101, 0.0101], [0.9, 0.9]], dtype=np.float32
    )
    want = oracle.bh_accelerations(
        positions, masses, g=G, theta=0.5, max_depth=2
    )
    got = np.asarray(
        bh_accelerations(
            jnp.asarray(positions),
            jnp.asarray(masses),
            g=G,
            theta=0.5,
            max_depth=2,
            body_chunk=4,
        )
    )
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * scale)
    # the aggregate self-pull is real: bodies 0/1 attract their own cell's
    # COM, which lies between them -> opposite-sign x components
    assert np.sign(got[0, 0]) != np.sign(got[1, 0])


@pytest.mark.slow
def test_trajectory_parity_with_oracle():
    """Multi-step BH trajectory within the 1e-3 budget of the f64 oracle
    (BASELINE.json: 'Barnes-Hut theta=0.5 within 1e-3 relative trajectory
    error')."""
    masses, positions = _cloud(400, seed=9)
    velocities = (
        np.random.default_rng(10).uniform(-1e-4, 1e-4, (400, 2))
    ).astype(np.float32)
    n_steps = 6
    want = oracle.simulate(
        positions, velocities, masses, n_steps, dt=1.0, g=G,
        engine="barnes_hut", theta=0.5,
    )[-1]

    p = jnp.asarray(positions)
    v = jnp.asarray(velocities)
    m = jnp.asarray(masses)
    for _ in range(n_steps):
        acc = bh_accelerations(p, m, g=G, theta=0.5, body_chunk=512)
        v = v + acc * 1.0
        p = p + v * 1.0
    # N-body dynamics is chaotic: close encounters amplify f32-vs-f64
    # rounding exponentially (the reference observes the same for its own
    # CPU-vs-GPU pair, observations.txt:43), so the budget is on the bulk
    # statistics: RMS within 1e-4 of scale, 99.5% of coordinates within
    # the 1e-3 budget.
    err = np.abs(np.asarray(p) - want)
    scale = np.abs(want).max()
    assert np.sqrt((err**2).mean()) < 1e-4 * scale
    assert np.quantile(err, 0.995) < 1e-3 * scale
