"""Entry points: measurement refuses a host without a GPU; results are
merged, never clobbered; the fake-mesh dry run never opens the card.

A measurement that silently falls back to the CPU prints a host number
under a device metric's name, so ``bench.py`` and ``chip_smoke.py`` exit
non-zero without a GPU and print no result line.  The reference's own
timing lines likewise come only from the device run (project.cu:1096-1102).
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_script(path, cwd, timeout=120):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, path], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=timeout,
    )


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_measurement_refuses_cpu(script):
    """On the CPU both measurement entry points exit non-zero, say that no
    GPU was found, and print no JSON result."""
    proc = _run_script(os.path.join(REPO, script), REPO)
    assert proc.returncode != 0
    assert "no GPU found" in proc.stderr
    assert '"ok"' not in proc.stdout and '"metric"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Without the package beside it the smoke test fails, printing no
    result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_script(str(tmp_path / "chip_smoke.py"), tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_require_gpu_on_cpu_exits():
    """The guard the measurement entry points share."""
    from nbody.device import require_gpu

    with pytest.raises(SystemExit, match="no GPU found"):
        require_gpu()


def test_baseline_main_merges_partial_rerun(monkeypatch, tmp_path):
    """``baseline.main --configs 3`` into an existing results file must
    refresh ONLY config 3: a partial re-run must not clobber the records
    it did not run, and the write is atomic (tmp + os.replace)."""
    from nbody.bench import baseline

    path = tmp_path / "results.json"
    prior = [
        {"config": 1, "pass_1e-3_at_step45_f64": True},
        {"config": 3, "steps_per_sec": 100.0},
        {"config": 4, "backend": "cpu-fake-8-device-mesh"},
    ]
    path.write_text(json.dumps(prior))
    monkeypatch.setattr(
        baseline, "config3", lambda: {"config": 3, "steps_per_sec": 170.0}
    )
    baseline.main(["--configs", "3", "--out", str(path)])
    report = json.loads(path.read_text())
    assert [r["config"] for r in report] == [1, 3, 4]
    assert report[1]["steps_per_sec"] == 170.0  # refreshed
    assert report[0] == prior[0] and report[2] == prior[2]  # untouched


def test_dryrun_parent_never_touches_backend(monkeypatch):
    """The dryrun parent must not query any JAX backend: it re-execs a
    CPU-pinned child, so the fake mesh never opens the card the parent
    may hold (one JAX process per card).  Every backend query in the
    parent explodes here."""
    import jax

    import __graft_entry__ as ge

    def explode(*a, **kw):
        raise AssertionError("parent touched the JAX backend")

    monkeypatch.setattr(jax, "devices", explode)
    monkeypatch.setattr(jax, "device_count", explode)
    monkeypatch.setattr(jax, "default_backend", explode)

    captured = {}

    def fake_run(cmd, **kw):
        captured["cmd"] = cmd
        captured["env"] = kw.get("env", {})
        captured["timeout"] = kw.get("timeout")
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.delenv(ge._CHILD_ENV, raising=False)

    ge.dryrun_multichip(8)

    # the child pins the CPU platform before any jax import side effects
    child_code = captured["cmd"][-1]
    assert "jax.config.update('jax_platforms', 'cpu')" in child_code
    assert captured["env"][ge._CHILD_ENV] == "1"
    assert "xla_force_host_platform_device_count" in captured["env"].get(
        "XLA_FLAGS", ""
    )
    assert captured["timeout"] is not None  # bounded, can't hang forever


def test_dryrun_child_sentinel_runs_impl(monkeypatch):
    """With the child sentinel set, dryrun_multichip runs the real impl
    in-process (no recursion into subprocesses)."""
    import __graft_entry__ as ge

    monkeypatch.setenv(ge._CHILD_ENV, "1")
    called = {}
    monkeypatch.setattr(
        ge, "_dryrun_impl", lambda n: called.setdefault("n", n)
    )
    ge.dryrun_multichip(4)
    assert called["n"] == 4


def test_scan_path_reports_overflow(capsys):
    """Fused runs must not silently keep overflowed steps (round-3 weak
    #6): run_scan surfaces per-step counts and warns like the contract
    loop."""
    from nbody import SimConfig
    from nbody.models.simulation import Simulation
    from nbody.rng import random_state

    cfg = SimConfig(
        n_bodies=2048, n_steps=2, engine="barnes_hut", seed=5,
        frontier_cap=32, group_size=256,
    )
    sim = Simulation(cfg, state=random_state(cfg))
    sim.run_scan()
    assert sim.last_scan_overflow is not None
    assert sim.last_scan_overflow.shape == (2,)
    assert sim.last_scan_overflow.sum() > 0
    err = capsys.readouterr().err
    assert "overflowed" in err and "fused runs do NOT retry" in err

    # an overflow-free engine reports all-zero counts and stays silent
    cfg_ok = SimConfig(n_bodies=256, n_steps=2, engine="naive", seed=5)
    sim_ok = Simulation(cfg_ok, state=random_state(cfg_ok))
    sim_ok.run_scan()
    assert sim_ok.last_scan_overflow.sum() == 0
    assert "overflowed" not in capsys.readouterr().err
