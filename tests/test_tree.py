"""Dense pyramid build vs the oracle's adaptive quadtree."""

import jax.numpy as jnp
import numpy as np
import pytest

from nbody.models.oracle import (
    AdaptiveQuadtree,
    compute_root_bounds,
)
from nbody.ops.tree import (
    build_quadtree,
    level_cell_size,
    morton_codes,
    root_bounds,
)


@pytest.fixture
def cloud(rng):
    n = 300
    masses = (10 ** rng.uniform(-1, np.log10(0.5), n)).astype(np.float32)
    positions = rng.uniform(-0.1, 0.1, (n, 2)).astype(np.float32)
    return masses, positions


def test_root_bounds_matches_oracle(cloud):
    _, positions = cloud
    got = np.asarray(root_bounds(jnp.asarray(positions)))
    want = compute_root_bounds(positions)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_root_bounds_degenerate():
    """Single-point cloud: 1e-6 pad fallback (project.cu:563-565)."""
    p = jnp.asarray([[0.5, 0.5], [0.5, 0.5]], jnp.float32)
    b = np.asarray(root_bounds(p))
    np.testing.assert_allclose(b, [0.5 - 1e-6, 0.5 + 1e-6] * 2, atol=1e-9)


def test_morton_matches_recursive_subdivision(cloud):
    """Cell assignment must follow DetermineChild's recursive-midpoint
    rule, including the >=-goes-high boundary convention."""
    _, positions = cloud
    bounds = root_bounds(jnp.asarray(positions))
    codes = np.asarray(morton_codes(jnp.asarray(positions), bounds, 9))
    b = np.asarray(bounds)

    # recompute one body's code by literal recursion (f32 like the engine)
    for i in [0, 17, 123]:
        x, y = np.float32(positions[i, 0]), np.float32(positions[i, 1])
        x_lo, x_hi = np.float32(b[0]), np.float32(b[1])
        y_lo, y_hi = np.float32(b[2]), np.float32(b[3])
        code = 0
        for _ in range(9):
            mx = np.float32((x_lo + x_hi) * np.float32(0.5))
            my = np.float32((y_lo + y_hi) * np.float32(0.5))
            bx = int(x >= mx)
            by = int(y >= my)
            x_lo, x_hi = (mx, x_hi) if bx else (x_lo, mx)
            y_lo, y_hi = (my, y_hi) if by else (y_lo, my)
            code = (code << 2) | (by << 1) | bx
        assert codes[i] == code


def test_pyramid_mass_and_com(cloud):
    masses, positions = cloud
    tree = build_quadtree(
        jnp.asarray(positions), jnp.asarray(masses), max_depth=9
    )
    total = masses.sum()
    for lv in tree.levels:
        np.testing.assert_allclose(
            float(jnp.sum(lv.mass)), total, rtol=1e-5
        )
        assert int(jnp.sum(lv.count)) == len(masses)
    root = tree.levels[0]
    com_want = (masses[:, None] * positions).sum(0) / total
    np.testing.assert_allclose(
        [float(root.comx[0]), float(root.comy[0])], com_want, rtol=1e-4
    )


def test_pyramid_counts_match_adaptive_structure(cloud):
    """Count pyramid must agree with the oracle's adaptive tree: every
    oracle node maps to the pyramid cell with the same occupancy."""
    masses, positions = cloud
    oracle_tree = AdaptiveQuadtree(max_depth=9).build(positions, masses)
    tree = build_quadtree(
        jnp.asarray(positions), jnp.asarray(masses), max_depth=9
    )
    counts = [np.asarray(lv.count) for lv in tree.levels]
    mass_lv = [np.asarray(lv.mass) for lv in tree.levels]

    # walk the oracle tree, tracking (level, morton cell)
    from nbody.models.oracle import CHILD0, TOTAL_MASS

    def visit(node_index, level, cell):
        node = oracle_tree.nodes[node_index]
        if node[TOTAL_MASS] > 0:
            np.testing.assert_allclose(
                mass_lv[level][cell], node[TOTAL_MASS], rtol=2e-3,
                err_msg=f"level {level} cell {cell}",
            )
        for c in range(4):
            child = int(node[CHILD0 + c])
            if child != -1:
                visit(child, level + 1, cell * 4 + c)

    visit(0, 0, 0)


def test_level_cell_size():
    bounds = jnp.asarray([0.0, 8.0, 0.0, 4.0])
    assert float(level_cell_size(bounds, 0)) == 8.0
    assert float(level_cell_size(bounds, 3)) == 1.0  # max(8/8, 4/8)
