"""Grouped (Morton-group dual-traversal) Barnes-Hut vs the f64 oracle.

The grouped engine's opening is conservative (group-bbox distance) and
close cells resolve by exact pairwise interaction instead of max-depth
aggregation, so forces differ from the reference DFS within the BH
approximation class — the budget here is the BASELINE 1e-3, not bit
parity (the exact per-body engine in test_barnes_hut.py covers that).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from nbody.models import oracle
from nbody.ops.bh_grouped import bh_accelerations_grouped
from nbody.physics import pair_accelerations_dense

G = 6.67e-11


def _cloud(n, seed=11):
    rng = np.random.default_rng(seed)
    masses = (10 ** rng.uniform(-1, np.log10(0.5), n)).astype(np.float32)
    positions = rng.uniform(-0.1, 0.1, (n, 2)).astype(np.float32)
    return masses, positions


@pytest.mark.parametrize(
    "group_size",
    [pytest.param(1, marks=pytest.mark.slow), 64,
     pytest.param(256, marks=pytest.mark.slow)],
)
def test_matches_oracle_within_budget(group_size):
    masses, positions = _cloud(600)
    want = oracle.bh_accelerations(positions, masses, g=G, theta=0.5)
    got, ovf = bh_accelerations_grouped(
        jnp.asarray(positions),
        jnp.asarray(masses),
        g=G,
        theta=0.5,
        group_size=group_size,
        group_chunk=8,
        return_diagnostics=True,
    )
    assert int(np.asarray(ovf).sum()) == 0
    scale = np.abs(want).max()
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-3 * scale)


def test_matches_allpairs_closely():
    """BH at theta=0.5 must stay within the usual approximation error of
    exact all-pairs (sanity: the direct/approx split adds no gross error)."""
    masses, positions = _cloud(800, seed=2)
    exact = np.asarray(
        pair_accelerations_dense(
            jnp.asarray(positions), jnp.asarray(masses), g=G,
            softening=1e-15,
        )
    )
    got = np.asarray(
        bh_accelerations_grouped(
            jnp.asarray(positions), jnp.asarray(masses), g=G, theta=0.5,
            group_chunk=8,
        )
    )
    scale = np.abs(exact).max()
    # theta=0.5 BH error is typically <1e-2 relative
    np.testing.assert_allclose(got, exact, atol=2e-2 * scale)


def test_self_exclusion_via_bit_exact_positions():
    """A body must not feel its own singleton cell or its own entry in a
    direct range (d2>0 guard with bit-exact positions)."""
    # two isolated far-apart bodies: force = exact two-body force
    masses = np.array([1.0, 2.0], dtype=np.float32)
    positions = np.array([[0.0, 0.0], [1.0, 0.0]], dtype=np.float32)
    got = np.asarray(
        bh_accelerations_grouped(
            jnp.asarray(positions), jnp.asarray(masses), g=G, theta=0.5,
            group_size=2, group_chunk=1,
        )
    )
    want = np.asarray(
        pair_accelerations_dense(
            jnp.asarray(positions), jnp.asarray(masses), g=G,
            softening=1e-15,
        )
    )
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_overflow_reported_not_silent():
    """Tiny caps must raise the per-body overflow flag."""
    masses, positions = _cloud(600, seed=4)
    _, ovf = bh_accelerations_grouped(
        jnp.asarray(positions),
        jnp.asarray(masses),
        g=G,
        theta=0.5,
        group_size=64,
        list_cap=8,
        direct_cap=8,
        direct_body_cap=8,
        group_chunk=8,
        return_diagnostics=True,
    )
    assert int(np.asarray(ovf).sum()) > 0


def test_clustered_distribution():
    """Dense Gaussian cluster + uniform background: the stress case for
    cap sizing and max-depth aggregation (many co-located bodies)."""
    rng = np.random.default_rng(3)
    n = 1024
    cluster = rng.normal(0.0, 1e-4, (n // 2, 2))  # ultra-dense knot
    background = rng.uniform(-0.1, 0.1, (n // 2, 2))
    positions = np.vstack([cluster, background]).astype(np.float32)
    masses = (10 ** rng.uniform(-1, 0, n)).astype(np.float32)
    want = oracle.bh_accelerations(positions, masses, g=G, theta=0.5)
    got, ovf = bh_accelerations_grouped(
        jnp.asarray(positions), jnp.asarray(masses), g=G, theta=0.5,
        group_size=128, group_chunk=8, return_diagnostics=True,
    )
    assert int(np.asarray(ovf).sum()) == 0
    scale = np.abs(want).max()
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-3 * scale)


def test_deterministic_across_calls():
    """Same inputs -> bit-identical accelerations (pure functional)."""
    masses, positions = _cloud(500, seed=6)
    a = np.asarray(bh_accelerations_grouped(
        jnp.asarray(positions), jnp.asarray(masses), g=G, group_chunk=8))
    b = np.asarray(bh_accelerations_grouped(
        jnp.asarray(positions), jnp.asarray(masses), g=G, group_chunk=8))
    np.testing.assert_array_equal(a, b)
