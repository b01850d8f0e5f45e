"""Checkpoint/resume: a resumed run must produce the identical trajectory
(strict superset of the reference's init-state persistence, SURVEY.md 5.4).
"""

import numpy as np

from nbody import SimConfig, make_state
from nbody.models.simulation import Simulation
from nbody.utils.checkpoint import load_checkpoint, save_checkpoint


def test_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    n = 64
    state = make_state(
        (10 ** rng.uniform(-1, 0, n)),
        rng.uniform(-0.1, 0.1, (n, 2)),
        rng.uniform(-1e-4, 1e-4, (n, 2)),
        time=3.0,
        step=3,
    )
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, state)
    loaded = load_checkpoint(path)
    np.testing.assert_array_equal(
        np.asarray(loaded.positions), np.asarray(state.positions)
    )
    assert float(loaded.time) == 3.0 and int(loaded.step) == 3


def test_resume_continues_identically(tmp_path):
    cfg = SimConfig(n_bodies=128, n_steps=6, engine="naive", seed=5)
    # straight run
    sim = Simulation(cfg)
    full, _ = sim.run_contract()

    # run 3, checkpoint, resume 3
    cfg_a = cfg.replace(
        n_steps=3,
        checkpoint_every=3,
        checkpoint_path=str(tmp_path / "mid.npz"),
    )
    sim_a = Simulation(cfg_a)
    sim_a.run_contract()
    mid = load_checkpoint(str(tmp_path / "mid.npz"))
    assert int(mid.step) == 3
    sim_b = Simulation(cfg.replace(n_steps=3), state=mid)
    resumed, _ = sim_b.run_contract()

    np.testing.assert_array_equal(
        np.asarray(resumed.positions), np.asarray(full.positions)
    )
    assert int(resumed.step) == int(full.step) == 6


def test_cli_resume(tmp_path, capsys):
    """--checkpoint-every + --resume through the CLI (SURVEY 5.4)."""
    from nbody.cli import main

    out = str(tmp_path)
    ck = str(tmp_path / "checkpoint.npz")
    assert main([
        "run", "--engine", "naive", "--n-bodies", "32", "--steps", "4",
        "--seed", "9", "--checkpoint-every", "4", "--output-dir", out,
    ]) == 0
    capsys.readouterr()
    assert main([
        "run", "--engine", "naive", "--n-bodies", "32", "--steps", "2",
        "--resume", ck, "--output-dir", out,
    ]) == 0
    # compare against a straight 6-step run
    from nbody import SimConfig
    from nbody.models.simulation import Simulation

    sim = Simulation(SimConfig(n_bodies=32, n_steps=6, engine="naive",
                               seed=9))
    want, _ = sim.run_contract()
    from nbody.utils.checkpoint import load_checkpoint

    # the resumed run rewrote the checkpoint? no — ck only written when
    # checkpoint_every set; verify via a fresh resumed Simulation instead
    mid = load_checkpoint(ck)
    sim2 = Simulation(SimConfig(n_bodies=32, n_steps=2, engine="naive"),
                      state=mid)
    resumed, _ = sim2.run_contract()
    np.testing.assert_array_equal(
        np.asarray(resumed.positions), np.asarray(want.positions)
    )


def test_run_scan_trajectory():
    """Compiled trajectory capture equals the per-step contract loop."""
    from nbody import SimConfig
    from nbody.models.simulation import Simulation

    cfg = SimConfig(n_bodies=48, n_steps=5, engine="naive", seed=2)
    sim_a = Simulation(cfg)
    final_a, traj = sim_a.run_scan_trajectory()
    assert traj.shape == (6, 48, 2)
    sim_b = Simulation(cfg)
    final_b, _ = sim_b.run_contract()
    np.testing.assert_allclose(
        np.asarray(final_a.positions), np.asarray(final_b.positions),
        rtol=1e-6,
    )
    np.testing.assert_array_equal(
        np.asarray(traj[-1]), np.asarray(final_a.positions)
    )
