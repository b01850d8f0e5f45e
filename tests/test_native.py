"""Native C++ reference engine vs the Python oracle (both implement the
reference semantics independently — agreement at f64 precision is strong
evidence both are right) and vs the JAX engines."""

import numpy as np
import pytest

from nbody.models import oracle

native = pytest.importorskip("nbody.utils.native")

try:
    native.load()
except native.NativeUnavailable as e:  # pragma: no cover
    pytest.skip(f"native toolchain unavailable: {e}", allow_module_level=True)

G = 6.67e-11


def _cloud(n, seed=0):
    rng = np.random.default_rng(seed)
    masses = 10 ** rng.uniform(-1, np.log10(0.5), n)
    positions = rng.uniform(-0.1, 0.1, (n, 2))
    velocities = rng.uniform(-1e-4, 1e-4, (n, 2))
    return masses, positions, velocities


def test_naive_matches_oracle():
    masses, positions, _ = _cloud(300)
    want = oracle.naive_accelerations(positions, masses, g=G)
    got = native.naive_accelerations(positions, masses, g=G)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_bh_matches_oracle():
    masses, positions, _ = _cloud(500, seed=3)
    want = oracle.bh_accelerations(positions, masses, g=G, theta=0.5)
    got = native.bh_accelerations(positions, masses, g=G, theta=0.5)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_bh_matches_oracle_shallow_tree():
    """Depth-capped aggregation paths (max_depth=2 forces co-location)."""
    masses, positions, _ = _cloud(200, seed=5)
    want = oracle.bh_accelerations(
        positions, masses, g=G, theta=0.5, max_depth=2
    )
    got = native.bh_accelerations(
        positions, masses, g=G, theta=0.5, max_depth=2
    )
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_dump_identical_to_oracle():
    """Byte-identical dumps: same structure, same formatting."""
    masses, positions, _ = _cloud(250, seed=7)
    tree = oracle.AdaptiveQuadtree(max_depth=9).build(positions, masses)
    want = "\n".join(tree.dump_lines(positions)) + "\n"
    got = native.tree_dump(positions, masses, max_depth=9)
    assert got == want


def test_simulate_matches_oracle_trajectory():
    masses, positions, velocities = _cloud(200, seed=9)
    want = oracle.simulate(
        positions, velocities, masses, 5, dt=1.0, g=G,
        engine="barnes_hut", theta=0.5,
    )[-1]
    got_p, _ = native.simulate(
        positions, velocities, masses, 5, dt=1.0, g=G,
        engine="barnes_hut", theta=0.5,
    )
    np.testing.assert_allclose(got_p, want, rtol=1e-9)
