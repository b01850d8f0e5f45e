"""3D (octree) path: tree invariants, kernels, engine accuracy, e2e.

The reference is 2D-only; its report names the octree / N_DIM=3
generalisation (project_report.pdf p.8) and ships a non-functional
plot_3d.py.  These tests pin the 3D path the same way the 2D tests pin
the quadtree path: NumPy f64 dense ground truth + structural invariants.
"""

import numpy as np
import jax.numpy as jnp
import pytest


G = 6.67e-11


def _dense_f64(pos64, m64, g=G):
    d = pos64[None, :, :] - pos64[:, None, :]
    r2 = (d**2).sum(-1)
    np.fill_diagonal(r2, 1.0)
    inv = g * m64[None, :] / (r2**1.5)
    np.fill_diagonal(inv, 0.0)
    return (d * inv[:, :, None]).sum(1)


@pytest.fixture(scope="module")
def cloud3(rng):
    n = 2048
    pos = rng.uniform(-0.1, 0.1, (n, 3))
    m = 10 ** rng.uniform(-1, np.log10(0.5), n)
    return (
        jnp.asarray(pos, jnp.float32),
        jnp.asarray(m, jnp.float32),
        pos,
        m,
    )


def test_octree_invariants(cloud3):
    from nbody.ops.tree3d import (
        R3_CNT,
        R3_M,
        R3_MX,
        R3_OCC,
        R3_SX,
        build_octree,
    )

    pos, m, pos64, m64 = cloud3
    n = pos.shape[0]
    t = build_octree(pos, m, max_depth=5)

    root = np.asarray(t.raw[0])
    assert root[0, R3_CNT] == n
    assert abs(root[0, R3_M] - m64.sum()) / m64.sum() < 1e-5

    com = (m64[:, None] * pos64).sum(0) / m64.sum()
    com_t = root[0, R3_MX : R3_MX + 3] / root[0, R3_M]
    assert np.abs(com - com_t).max() < 1e-6

    # every level conserves the body count
    for r in t.raw:
        assert abs(np.asarray(r)[:, R3_CNT].sum() - n) < 1e-3

    # parent occupancy bits == mask of child counts
    for lv in range(len(t.raw) - 1):
        par = np.asarray(t.raw[lv])
        ch = np.asarray(t.raw[lv + 1])
        bits = (
            ((ch[:, R3_CNT].reshape(-1, 8) > 0) * (1 << np.arange(8)))
            .sum(1)
        )
        assert (par[:, R3_OCC].astype(int) == bits).all()

    # singleton leaf cells carry bit-exact body positions
    leaf = np.asarray(t.raw[-1])
    codes = np.asarray(t.codes)
    cell = np.where(leaf[:, R3_CNT] == 1)[0][0]
    body = np.where(codes == cell)[0][0]
    assert (leaf[cell, R3_SX : R3_SX + 3] == np.asarray(pos)[body]).all()


def test_morton3_cell_consistency(cloud3):
    from nbody.ops.tree3d import morton_codes_3d, root_bounds_3d

    pos, _, pos64, _ = cloud3
    bounds = root_bounds_3d(pos)
    codes = np.asarray(morton_codes_3d(pos, bounds, 4))
    assert codes.min() >= 0 and codes.max() < 8**4
    # the x bit of the first level is bit 0 of the top 3-bit group
    b = np.asarray(bounds)
    mid_x = (b[0] + b[1]) * 0.5
    top = codes >> (3 * 3)
    assert ((top & 1) == (np.asarray(pos)[:, 0] >= mid_x)).all()


def test_allpairs_kernel_3d(cloud3):
    from nbody.ops.allpairs import allpairs_accelerations

    pos, m, pos64, m64 = cloud3
    a = np.asarray(allpairs_accelerations(pos, m, g=G, interpret=True))
    dense = _dense_f64(pos64, m64)
    rel = np.linalg.norm(a - dense, axis=1) / (
        np.linalg.norm(dense, axis=1) + 1e-30
    )
    assert rel.max() < 1e-4


def test_grouped3_vs_dense(cloud3):
    from nbody.ops.bh3d import bh3_accelerations_grouped

    pos, m, pos64, m64 = cloud3
    a, ovf = bh3_accelerations_grouped(
        pos, m, g=G, theta=0.5, return_diagnostics=True
    )
    assert int(np.asarray(ovf).sum()) == 0
    dense = _dense_f64(pos64, m64)
    rel = np.linalg.norm(np.asarray(a) - dense, axis=1) / (
        np.linalg.norm(dense, axis=1) + 1e-30
    )
    # conservative group acceptance: median well under the 1e-3 budget
    assert np.median(rel) < 1e-4
    assert np.quantile(rel, 0.99) < 5e-3


@pytest.mark.slow
def test_grouped3_dead_level_skip_equivalence(cloud3, monkeypatch):
    """The lax.cond dead-level runtime skip (bh3d._collect_lists_3d) is
    bit-exact vs the straight-line walk.  frontier_cap=2048 activates
    the >=1024-lane gate at this small N; NBODY_DEAD_LEVEL_SKIP=0 is
    the same-trace escape hatch (read at trace time, so the module is
    reloaded per setting)."""
    import importlib

    import nbody.ops.bh3d as bh3d

    pos, m, _, _ = cloud3
    out = {}
    try:
        for skip in ("1", "0"):
            monkeypatch.setenv("NBODY_DEAD_LEVEL_SKIP", skip)
            importlib.reload(bh3d)
            a, ovf = bh3d.bh3_accelerations_grouped(
                pos, m, g=G, theta=0.5, frontier_cap=2048,
                return_diagnostics=True,
            )
            assert int(np.asarray(ovf).sum()) == 0
            out[skip] = np.asarray(a)
    finally:
        monkeypatch.delenv("NBODY_DEAD_LEVEL_SKIP", raising=False)
        importlib.reload(bh3d)
    assert np.array_equal(out["1"], out["0"])


@pytest.mark.slow
def test_grouped3_theta_zero_converges(cloud3):
    from nbody.ops.bh3d import bh3_accelerations_grouped

    pos, m, pos64, m64 = cloud3
    a = np.asarray(
        bh3_accelerations_grouped(pos, m, g=G, theta=1e-6)
    )
    dense = _dense_f64(pos64, m64)
    rel = np.linalg.norm(a - dense, axis=1) / (
        np.linalg.norm(dense, axis=1) + 1e-30
    )
    assert rel.max() < 1e-4


@pytest.mark.slow
def test_simulation_3d_contract(tmp_path):
    from nbody import SimConfig
    from nbody.models.simulation import Simulation

    cfg = SimConfig(
        n_bodies=512,
        n_dim=3,
        n_steps=3,
        engine="barnes_hut",
        seed=11,
        save_positions=True,
        output_dir=str(tmp_path),
    )
    state, timing = Simulation(cfg).run_contract()
    assert state.positions.shape == (512, 3)

    # five-column schema the reference's plot_3d.py parses (plot_3d.py:11-15)
    rows = [
        line.split()
        for line in (tmp_path / "positions.txt").read_text().splitlines()
        if line.strip()
    ]
    assert all(len(r) == 5 for r in rows)
    assert len(rows) == 4 * 512  # step 0 + 3 steps

    from nbody.bench import plots

    out = plots.trajectories_3d(
        str(tmp_path / "positions.txt"), str(tmp_path / "p3.png")
    )
    assert (tmp_path / "p3.png").exists(), out


def test_simulation_3d_energy_drift():
    """Symplectic Euler on a soft 3D cloud: momentum is conserved to
    f32 roundoff (forces are antisymmetric pair sums)."""
    from nbody import SimConfig
    from nbody.models.simulation import Simulation
    from nbody.physics import total_momentum

    cfg = SimConfig(n_bodies=512, n_dim=3, n_steps=10, engine="naive", seed=3)
    sim = Simulation(cfg)
    p0 = np.asarray(total_momentum(sim.state))
    sim.run_scan()
    p1 = np.asarray(total_momentum(sim.state))
    # velocities ~1e-4, masses ~0.3: |p| ~ 1e-2; drift must be roundoff
    assert np.abs(p1 - p0).max() < 1e-6


@pytest.mark.slow
def test_sharded_3d_matches_single_device(rng):
    """dp_barnes_hut_grouped3 on the fake 8-device mesh reproduces the
    single-device grouped-3D trajectory."""
    import jax

    if jax.device_count() < 8:
        pytest.skip("needs 8 fake devices")
    from nbody.config import MeshConfig, SimConfig
    from nbody.models.simulation import Simulation
    from nbody.parallel import make_mesh, make_sharded_step, shard_state
    from nbody.rng import random_state

    cfg = SimConfig(
        n_bodies=1024, n_dim=3, n_steps=3, engine="barnes_hut", seed=5,
        mesh=MeshConfig(dp=8),
    )
    state0 = random_state(cfg)

    sim_single = Simulation(cfg, state=state0)
    sim_single.run_scan()
    ref = np.asarray(sim_single.state.positions)

    mesh = make_mesh(8)
    step = make_sharded_step(cfg, mesh, "dp_barnes_hut_grouped3")
    state = shard_state(random_state(cfg), mesh)
    for _ in range(3):
        state = step(state)
    got = np.asarray(state.positions)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() / scale < 1e-5


@pytest.mark.slow
def test_sharded3_window_mode_matches_grouped(rng):
    """dp_barnes_hut_sharded3 (per-chip sources O(N/devices + tree))
    tracks the single-device grouped-3D trajectory on a
    bounded-separation jittered 3D grid (see the 2D mirror in
    tests/test_parallel.py for why uniform-random states are not
    assertable)."""
    import jax

    if jax.device_count() < 8:
        pytest.skip("needs 8 fake devices")
    from nbody.config import MeshConfig, SimConfig
    from nbody.ops.bh3d import bh3_accelerations_grouped
    from nbody.ops.tree3d import morton_codes_3d, root_bounds_3d
    from nbody.parallel import make_mesh, make_sharded_step, shard_state
    from nbody.physics import integrate
    from nbody.state import make_state

    side = 12
    n = side**3  # 1728
    r = np.random.default_rng(3)
    gx, gy, gz = np.meshgrid(*([np.arange(side)] * 3))
    p = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float64)
    p = ((p + r.uniform(0.25, 0.75, p.shape)) / side * 0.2 - 0.1).astype(
        np.float32
    )
    m = (10 ** r.uniform(-1, np.log10(0.5), n)).astype(np.float32)
    v = r.uniform(-1e-4, 1e-4, (n, 3)).astype(np.float32)

    import jax.numpy as jnp

    md = 5  # deep enough that out-of-window close cells aggregate at
    # small cell sizes (md=4's 1/16-domain leaves gave ~3e-4*scale diffs)
    codes = np.asarray(
        morton_codes_3d(jnp.asarray(p), root_bounds_3d(jnp.asarray(p)), md)
    )
    order = np.argsort(codes)
    m, p, v = m[order], p[order], v[order]

    cfg = SimConfig(
        n_bodies=n, n_dim=3, engine="barnes_hut", group_size=216,
        group_chunk=8, max_depth=md, mesh=MeshConfig(dp=8),
    )
    mesh = make_mesh(8)
    state = shard_state(make_state(m, p, v), mesh)
    step = make_sharded_step(cfg, mesh, "dp_barnes_hut_sharded3")

    G = 6.67e-11
    ref = make_state(m, p, v)
    for _ in range(3):
        state = step(state)
        acc = bh3_accelerations_grouped(
            ref.positions, ref.masses, g=G, max_depth=md,
            group_size=216, group_chunk=8,
        )
        ref = integrate(ref, acc, dt=1.0)
    got = np.asarray(state.positions)
    want = np.asarray(ref.positions)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-4 * scale)


def test_make_state_rejects_bad_dims():
    from nbody.state import make_state

    with pytest.raises(ValueError):
        make_state(np.ones(4), np.ones((4, 4)), np.ones((4, 4)))
    make_state(np.ones(4), np.ones((4, 3)), np.ones((4, 3)))  # ok


def test_cli_run_3d(tmp_path, capsys):
    """CLI --dims 3 end-to-end: timing contract + five-column positions."""
    from nbody.cli import main

    rc = main(
        [
            "run", "--dims", "3", "--engine", "barnes_hut",
            "--n-bodies", "256", "--steps", "2",
            "--save-positions", "--output-dir", str(tmp_path),
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "milliseconds" in out and "microseconds" in out
    rows = [
        line.split()
        for line in (tmp_path / "positions.txt").read_text().splitlines()
        if line.strip()
    ]
    assert all(len(r) == 5 for r in rows)


@pytest.mark.slow
def test_cli_compare_3d(tmp_path, capsys):
    """3D compare: naive vs grouped octree BH from one init (checkEqual
    workflow, project.cu:1027-1047, generalised)."""
    from nbody.cli import main

    rc = main(
        [
            "compare", "--dims", "3", "--n-bodies", "256", "--steps", "2",
            "--engine-a", "naive", "--engine-b", "barnes_hut",
            "--tol", "1e-5", "--output-dir", str(tmp_path),
        ]
    )
    out = capsys.readouterr().out
    assert "final positions" in out
    assert rc == 0, out


def test_cli_compare_3d_rejects_host_engines(tmp_path, capsys):
    from nbody.cli import main

    rc = main(
        [
            "compare", "--dims", "3", "--n-bodies", "64", "--steps", "1",
            "--engine-a", "native", "--engine-b", "barnes_hut",
            "--output-dir", str(tmp_path),
        ]
    )
    assert rc == 2


@pytest.mark.slow
def test_cli_sweep_3d_strong(tmp_path, capsys, monkeypatch):
    """Strong-scaling sweep in 3D on the fake mesh; reference results-file
    shape preserved."""
    import jax

    if jax.device_count() < 2:
        pytest.skip("needs fake multi-device mesh")
    monkeypatch.chdir(tmp_path)
    from nbody.cli import main

    rc = main(
        [
            "sweep", "--dims", "3", "--engine", "barnes_hut",
            "--experiment", "strong", "--n-bodies", "256", "--steps", "2",
            "--device-counts", "1,2", "--repeats", "1",
            "--results-file", "sw3.txt",
        ]
    )
    assert rc == 0
    text = (tmp_path / "sw3.txt").read_text()
    assert "n_bodies, n_threads, n_simulations, runtime" in text
    # one point line per device count (+ the embedded stdout timing
    # lines the reference plotters parse)
    assert "256, 1, 2, " in text and "256, 2, 2, " in text
    assert text.count("GPU total computation took") == 2


@pytest.mark.slow
def test_metrics_csv_3d_tree_stats(tmp_path):
    """3D runs record octree statistics in the metrics CSV (the 2D
    tree_nodes/tree_max_depth observable, observations.txt:59-65)."""
    import csv

    from nbody import SimConfig
    from nbody.models.simulation import Simulation

    cfg = SimConfig(
        n_bodies=256, n_dim=3, n_steps=2, engine="barnes_hut", seed=2,
        metrics_csv="m3.csv", output_dir=str(tmp_path),
    )
    Simulation(cfg).run_contract()
    rows = list(csv.DictReader(open(tmp_path / "m3.csv")))
    assert len(rows) == 3
    assert all(int(r["tree_nodes"]) > 8 for r in rows)
    assert all(int(r["tree_max_depth"]) >= 1 for r in rows)


def test_frontier_schedule_3d_covers_measured_demand():
    """The dcm=128 zone schedule must cover the scripts/demand.py
    calibration measurements (uniform + two-blob collapsed; the round-3
    single-level ramp overflowed at 512K where N/dcm = 8^4 puts the
    termination spike astride l_t and l_t+1)."""
    from nbody.ops.bh3d import cap_defaults_3d, frontier_schedule_3d
    from nbody.ops.tree3d import default_max_depth3

    # demand entering levels 1..max_depth, max over groups (gs=2048,
    # theta=0.5; see frontier_schedule_3d docstring)
    measured = {
        65536: [
            [8, 64, 512, 2364, 1493, 0],           # uniform
            [4, 24, 55, 114, 452, 1540],           # blobs
        ],
        262144: [
            [8, 64, 512, 1990, 9763, 8, 0],
            [7, 27, 94, 412, 1794, 5573, 13600],
        ],
        524288: [
            [8, 64, 512, 1650, 9160, 0, 0],        # uniform
            [8, 31, 67, 267, 1139, 4216, 9960],    # blobs
        ],
        1048576: [
            [8, 64, 512, 1650, 8048, 0, 0],
            [8, 39, 108, 215, 965, 3672, 9608],
        ],
    }
    for n, profiles in measured.items():
        md = default_max_depth3(n)
        caps = cap_defaults_3d(n)
        sched = frontier_schedule_3d(caps["frontier_cap"], md, n)
        for prof in profiles:
            assert len(prof) == md
            for level, demand in enumerate(prof, start=1):
                assert demand <= sched[level], (n, level, demand, sched)
        if n >= 524288:
            # per-group approx/direct maxima (same calibration runs;
            # the probes behind these literals are 512K+-specific)
            assert caps["list_cap"] >= 10467 * 1.3  # 512K blobs, 1.3x
            assert caps["direct_cap"] >= 6368  # 512K dcm=64 probe bound
    # worst group after the first step of the seed-0 uniform 1M cloud
    # (measured on the card: flung near-collision pairs grow the root box)
    assert cap_defaults_3d(1 << 20)["list_cap"] >= 15997 * 1.25


def test_frontier_schedule_2d_covers_measured_demand():
    """The 2D schedule/caps must cover the scripts/demand.py
    calibration (the round-2 uniform-only calibration overflowed on the
    collapsed distribution at 64K and 1M — direct cells, approx list,
    and the max-depth frontier tail)."""
    from nbody.ops.bh_grouped import cap_defaults, frontier_schedule

    measured = {
        65536: dict(
            frontier=[
                [4, 16, 64, 122, 276, 722, 56, 0, 0],      # uniform
                [4, 12, 36, 44, 112, 304, 780, 1468, 60],  # blobs
            ],
            approx=566, direct=2018,
        ),
        1048576: dict(
            frontier=[
                [4, 16, 64, 112, 224, 448, 1024, 2646, 224],
                [4, 12, 37, 71, 139, 320, 816, 2104, 5104],
            ],
            approx=5750, direct=1743,
        ),
    }
    md = 9
    for n, m in measured.items():
        caps = cap_defaults(2048, n)
        sched = frontier_schedule(caps["frontier_cap"], md, n)
        for prof in m["frontier"]:
            for level, demand in enumerate(prof, start=1):
                # headroom where the cap prunes; full-level caps can't
                # exceed the level size
                need = (
                    demand * 1.2 if sched[level] < 4**level else demand
                )
                assert need <= sched[level], (n, level, demand, sched)
        assert caps["list_cap"] >= m["approx"] * 1.3, n
        assert caps["direct_cap"] >= m["direct"] * 1.2, n
