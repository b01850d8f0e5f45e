"""Metrics CSV, debug validation, checkify force checks."""

import csv

import jax.numpy as jnp
import numpy as np
import pytest

from nbody import SimConfig, make_state
from nbody.physics import pair_accelerations_dense
from nbody.utils.debug import checked_accel, validate_state
from nbody.utils.metrics import MetricsWriter, tree_stats

G = 6.67e-11


def _state(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return make_state(
        10 ** rng.uniform(-1, 0, n),
        rng.uniform(-0.1, 0.1, (n, 2)),
        rng.uniform(-1e-4, 1e-4, (n, 2)),
    )


def test_metrics_csv(tmp_path):
    state = _state()
    w = MetricsWriter(str(tmp_path / "m.csv"), g=G)
    stats = tree_stats(state.positions, state.masses)
    w.record(state, stats)
    w.flush()
    rows = list(csv.DictReader(open(tmp_path / "m.csv")))
    assert len(rows) == 1
    assert float(rows[0]["kinetic_energy"]) > 0
    assert int(rows[0]["tree_nodes"]) >= 1
    # adaptive tree size should be around the reference's ~3N empirical
    # rule (observations.txt:59-65) — loose sanity bounds
    assert 64 <= int(rows[0]["tree_nodes"]) <= 64 * 10


@pytest.mark.slow
def test_metrics_csv_through_run_contract(tmp_path):
    """--metrics-csv runs on the tree engine must produce non-empty
    tree_nodes / tree_max_depth columns (the integration the reference's
    dev log tracks by hand, observations.txt:59-65)."""
    from nbody.models.simulation import Simulation

    cfg = SimConfig(
        n_bodies=64,
        n_steps=3,
        engine="barnes_hut",
        seed=11,
        metrics_csv="metrics.csv",
        output_dir=str(tmp_path),
    )
    Simulation(cfg).run_contract()
    rows = list(csv.DictReader(open(tmp_path / "metrics.csv")))
    assert len(rows) == 4  # step 0 + 3 steps, like savePositions
    for row in rows:
        assert int(row["tree_nodes"]) >= 1
        assert row["tree_max_depth"] != ""
        assert float(row["kinetic_energy"]) > 0

    # opt-out leaves the columns empty but keeps the CSV
    cfg2 = cfg.replace(metrics_csv="metrics2.csv", metrics_tree=False)
    Simulation(cfg2).run_contract()
    rows2 = list(csv.DictReader(open(tmp_path / "metrics2.csv")))
    assert rows2[0]["tree_nodes"] == ""


@pytest.mark.slow
def test_energy_finite_and_conserved_at_scale(tmp_path):
    """total_energy must be finite above the old 16,384-body dense cutoff
    (round-2 verdict item 6: no NaN energy at flagship N) and drift only
    slightly across the run (conserved-quantity reasoning, reference
    report pp.6 / observations.txt tree-collapse narrative)."""
    from nbody.models.simulation import Simulation

    # Jittered grid: bounded minimum separation.  A uniform-random cloud
    # contains tight pairs whose orbital period no reasonable dt
    # resolves (unsoftened force; the reference's own divergence
    # mechanism, observations.txt:43) — no integrator conserves energy
    # across an unresolved binary, so conservation must be asserted on a
    # collision-free state.
    side = 157
    n = side * side  # 24,649 > the old 16,384 dense-intermediate gate
    rng = np.random.default_rng(5)
    gx, gy = np.meshgrid(np.arange(side), np.arange(side))
    pos = np.stack([gx, gy], -1).reshape(-1, 2).astype(np.float64)
    pos = (pos + rng.uniform(0.25, 0.75, pos.shape)) / side * 0.2 - 0.1
    state = make_state(
        10 ** rng.uniform(-1, np.log10(0.5), n),
        pos,
        rng.uniform(-1e-4, 1e-4, (n, 2)),
    )
    cfg = SimConfig(
        n_bodies=n,
        n_steps=2,
        engine="barnes_hut",
        metrics_csv="metrics.csv",
        metrics_tree=False,
        output_dir=str(tmp_path),
    )
    Simulation(cfg, state=state).run_contract()
    rows = list(csv.DictReader(open(tmp_path / "metrics.csv")))
    assert len(rows) == 3
    energies = [float(r["total_energy"]) for r in rows]
    assert all(np.isfinite(e) for e in energies)
    pes = [float(r["potential_energy"]) for r in rows]
    assert all(np.isfinite(p) and p < 0 for p in pes)
    # semi-implicit Euler on a dilute cloud: energy drift per step is
    # tiny relative to the potential scale
    scale = abs(pes[0])
    drift = max(abs(e - energies[0]) for e in energies)
    assert drift <= 1e-2 * scale, (drift, scale)


def test_potential_energy_scalable_matches_dense():
    """The chunked path must agree with the dense diagnostic."""
    from nbody.physics import (
        potential_energy,
        potential_per_body_chunked,
    )

    state = _state(n=900, seed=4)
    phi = potential_per_body_chunked(
        state.positions, state.masses, g=G, chunk=256
    )
    pe = 0.5 * float(jnp.sum(state.masses * phi))
    want = float(potential_energy(state, G))
    assert abs(pe - want) <= 1e-5 * abs(want)


def test_tree_stats_depth():
    # two bodies in the same finest cell force full depth
    state = make_state(
        [1.0, 1.0, 1.0],
        [[0.0, 0.0], [1e-9, 1e-9], [0.5, 0.5]],
        [[0.0, 0.0]] * 3,
    )
    stats = tree_stats(state.positions, state.masses, max_depth=9)
    assert stats["max_depth"] == 9


def test_validate_state_rejects_bad():
    state = _state()
    validate_state(state)  # fine
    bad = make_state(
        np.asarray(state.masses),
        np.where(np.arange(64)[:, None] == 3, np.nan, state.positions),
        np.asarray(state.velocities),
    )
    with pytest.raises(ValueError, match="non-finite positions"):
        validate_state(bad)


def test_checked_accel_flags_nonfinite():
    def bad_accel(positions, masses):
        return pair_accelerations_dense(positions, masses, g=G) / 0.0

    err, _ = checked_accel(bad_accel)(
        jnp.asarray([[0.0, 0.0], [1.0, 0.0]]), jnp.asarray([1.0, 1.0])
    )
    with pytest.raises(Exception):
        err.throw()

    def good_accel(positions, masses):
        return pair_accelerations_dense(positions, masses, g=G)

    err, acc = checked_accel(good_accel)(
        jnp.asarray([[0.0, 0.0], [1.0, 0.0]]), jnp.asarray([1.0, 1.0])
    )
    err.throw()  # no error
    assert np.isfinite(np.asarray(acc)).all()


def test_format_bodies():
    from nbody.utils.textio import format_bodies

    out = format_bodies([1.5], [[0.25, -0.5]], [[1e-4, 0.0]])
    assert out.splitlines() == [
        "Body 0:",
        "  Mass: 1.5",
        "  Position: [ 0.25 -0.5 ]",
        "  Velocity: [ 0.0001 0 ]",
    ]


@pytest.mark.slow
def test_adaptive_caps_retry(tmp_path, capsys):
    """A step whose traversal caps overflow is recomputed with 4x caps
    (lazily compiled); the retried step matches a run configured with
    the larger caps from the start, and overflow is not reported."""
    import numpy as np

    from nbody import SimConfig
    from nbody.models.simulation import Simulation
    from nbody.rng import random_state

    # a frontier cap far below demand at this N forces overflow
    base = dict(
        n_bodies=2048, n_steps=2, engine="barnes_hut", seed=5,
        frontier_cap=32, group_size=256, output_dir=str(tmp_path),
    )
    cfg = SimConfig(**base)
    state0 = random_state(cfg)

    sim = Simulation(cfg, state=state0)
    final, _ = sim.run_contract()
    err = capsys.readouterr().err
    assert "retrying with 4x caps" in err

    from nbody.models.engines import resolved_caps

    caps4 = {k: 4 * v for k, v in resolved_caps(cfg).items()}
    cfg_big = SimConfig(**{**base, **caps4})
    ref = Simulation(cfg_big, state=state0)
    final_ref, _ = ref.run_contract()
    err_ref = capsys.readouterr().err
    assert "retrying" not in err_ref  # 4x caps don't overflow here
    np.testing.assert_array_equal(
        np.asarray(final.positions), np.asarray(final_ref.positions)
    )

    # warn-only mode preserves the reference behavior
    cfg_off = SimConfig(**{**base, "adaptive_caps": False})
    Simulation(cfg_off, state=state0).run_contract()
    err_off = capsys.readouterr().err
    assert "retrying" not in err_off
    assert "overflowed" in err_off
