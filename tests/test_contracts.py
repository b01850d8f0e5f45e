"""Text-file contracts: byte-format parity with the reference's consumers.

The parsers reimplemented here are the *contracts* from SURVEY.md 2.11 —
the regex plot_quadtree.py:7-9 matches and the column layout plot_2d.py
expects — so a format drift in our writers fails here before it breaks
the reference's plotting suite.
"""

import os
import re

import numpy as np
import pytest

from nbody.models.oracle import AdaptiveQuadtree
from nbody.utils.textio import (
    PositionsWriter,
    cxx_ostream,
    cxx_to_string,
    load_init_triplet,
    read_positions_file,
    save_init_triplet,
)

# The exact occupant regex of the reference's plot_quadtree.py:7-9.
OCCUPANT_RE = re.compile(
    r"occupantIndex=(-?\d+)\s+occupantPos=\(([-0-9.e+]+),([-0-9.e+]+)\)"
)


def _cloud(n, seed=0):
    rng = np.random.default_rng(seed)
    masses = 10 ** rng.uniform(-1, np.log10(0.5), n)
    positions = rng.uniform(-0.1, 0.1, (n, 2))
    velocities = rng.uniform(-1e-4, 1e-4, (n, 2))
    return masses, positions, velocities


def test_cxx_formatting():
    """C++ ostream (%.6g) and std::to_string (%.6f) reproductions."""
    assert cxx_ostream(0.1) == "0.1"
    assert cxx_ostream(1e-15) == "1e-15"
    assert cxx_ostream(-0.0501751) == "-0.0501751"
    assert cxx_ostream(123456.789) == "123457"
    assert cxx_to_string(1.0) == "1.000000"
    assert cxx_to_string(-0.046444) == "-0.046444"


def test_init_triplet_roundtrip(tmp_path):
    masses, positions, velocities = _cloud(100)
    save_init_triplet(str(tmp_path), masses, positions, velocities)
    m, p, v = load_init_triplet(
        str(tmp_path / "masses_init.txt"),
        str(tmp_path / "positions_init.txt"),
        str(tmp_path / "velocities_init.txt"),
        100,
    )
    # 6 significant digits of round-trip fidelity (the reference's own
    # save/load precision)
    np.testing.assert_allclose(m, masses, rtol=1e-5)
    np.testing.assert_allclose(p, positions, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(v, velocities, rtol=1e-4, atol=1e-10)


def test_reference_golden_fixtures():
    """Load the reference's committed 40,960-body golden init triplet
    (SURVEY.md 2.8) if the reference mount is present."""
    ref = "/root/reference/implementation"
    if not os.path.exists(os.path.join(ref, "masses_init.txt")):
        pytest.skip("reference fixtures not mounted")
    m, p, v = load_init_triplet(
        os.path.join(ref, "masses_init.txt"),
        os.path.join(ref, "positions_init.txt"),
        os.path.join(ref, "velocities_init.txt"),
        40960,
    )
    assert m.shape == (40960,) and p.shape == (40960, 2)
    assert 0.009 < m.min() and m.max() < 10.001  # log-uniform 1e-2..1e1
    assert np.abs(p).max() <= 0.1 and np.abs(v).max() <= 1e-4


def test_positions_writer_format(tmp_path):
    """`time body x y ` rows incl. step 0 (savePositions project.cu:855)."""
    path = str(tmp_path / "positions.txt")
    w = PositionsWriter(path)
    pos = np.array([[0.099679, -0.046444], [1.5, -2.25]])
    w.append(0.0, pos)
    w.append(1.0, pos + 1)
    w.flush()
    raw = open(path).read().splitlines()
    assert raw[0] == "0.000000 0 0.099679 -0.046444 "
    assert raw[3] == "1.000000 1 2.500000 -1.250000 "
    data = read_positions_file(path)
    assert data.shape == (4, 4)
    np.testing.assert_allclose(data[0], [0.0, 0, 0.099679, -0.046444])


def test_quadtree_dump_contract(tmp_path):
    """Dump lines must parse with plot_quadtree.py's token layout and
    occupant regex; structure is a valid pre-order DFS."""
    masses, positions, _ = _cloud(200, seed=4)
    tree = AdaptiveQuadtree(max_depth=9).build(positions, masses)
    lines = tree.dump_lines(positions)

    assert len(lines) == len(tree)  # every node dumped exactly once
    depths = []
    n_occupants = 0
    for line in lines:
        tokens = line.split()
        assert len(tokens) >= 6
        depth = int(tokens[0])
        x0, x1, y0, y1, mass = map(float, tokens[1:6])
        assert x0 < x1 and y0 < y1 and mass >= 0
        depths.append(depth)
        m = OCCUPANT_RE.findall(line)
        if m:
            n_occupants += 1
            occ_idx = int(m[0][0])
            ox, oy = float(m[0][1]), float(m[0][2])
            if occ_idx >= 0:
                # occupant position is the body's own position (6 sig digits)
                np.testing.assert_allclose(
                    [ox, oy], positions[occ_idx], rtol=1e-4, atol=1e-6
                )
        else:
            assert mass == 0.0  # only empty nodes have no occupant info
    # pre-order DFS: first node is the root at depth 0 and depth never
    # jumps by more than +1
    assert depths[0] == 0
    assert all(b - a <= 1 for a, b in zip(depths, depths[1:]))
    assert n_occupants >= 200  # every body appears (plus internal COMs)


def test_dump_negative_encoding_single_occupant_max_depth():
    """Single body in a max-depth cell dumps occupantIndex = -index-2
    (project.cu:376)."""
    # max_depth=1: grid 2x2; two bodies in different cells of the same
    # quadrant force subdivision to depth 1 where each sits alone.
    masses = np.array([1.0, 2.0])
    positions = np.array([[0.1, 0.1], [0.9, 0.9]])
    tree = AdaptiveQuadtree(max_depth=1).build(positions, masses)
    lines = tree.dump_lines(positions)
    neg = [l for l in lines if "occupantIndex=-" in l and "-1 " not in l]
    found = {
        int(m.group(1))
        for l in lines
        for m in [OCCUPANT_RE.search(l)]
        if m and int(m.group(1)) <= -2
    }
    assert found == {-2, -3}  # -0-2 and -1-2


def test_check_equal(capsys):
    """checkEqual verdict contract (project.cu:1027-1047)."""
    from nbody.utils.textio import check_equal

    a = np.zeros((3, 2))
    assert check_equal(a, a + 1e-12, "final positions")
    assert "are the same" in capsys.readouterr().out
    assert not check_equal(a, a + 1e-3, "final positions")
    out = capsys.readouterr().out
    assert "NOT the same" in out and "Difference at index [0][0]" in out
