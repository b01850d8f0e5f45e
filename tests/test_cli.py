"""CLI + sweep harness: stdout timing contract and results-file format.

The format checks reimplement the regexes of the reference's analysis
layer (plot_first_scale.py:55-59, plot_second_scale.py:19-20) so a drift
in our emitters fails here before it breaks those plotters.
"""

import os
import re

import numpy as np
import pytest

from nbody.cli import main

TOTAL_RE = re.compile(r"GPU total computation took\s+(\d+)\s+milliseconds\.")
PARALLEL_RE = re.compile(
    r"GPU parallel computation took\s+(\d+)\s+microseconds"
)
CONFIG_RE = re.compile(r"^\s*(\d+)\s*,\s*([^,]+)\s*,\s*(\d+)\s*,")
CONFIG5_RE = re.compile(r"^\s*(\d+)\s*,\s*(\d+)\s*,\s*(\d+)\s*,\s*(\d+)\s*,")


def test_run_prints_timing_contract(tmp_path, capsys):
    rc = main(
        [
            "run",
            "--engine",
            "naive",
            "--n-bodies",
            "64",
            "--steps",
            "2",
            "--output-dir",
            str(tmp_path),
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert TOTAL_RE.search(out), out
    assert PARALLEL_RE.search(out), out


def test_run_with_files_and_init_roundtrip(tmp_path, capsys):
    rc = main(
        [
            "run",
            "--engine",
            "naive",
            "--n-bodies",
            "64",
            "--steps",
            "2",
            "--save-init",
            "--save-positions",
            "--output-dir",
            str(tmp_path),
        ]
    )
    assert rc == 0
    capsys.readouterr()
    assert (tmp_path / "masses_init.txt").exists()
    assert (tmp_path / "positions.txt").exists()
    # reload the saved init (README.md:14-18 mode 3) and check determinism
    rc = main(
        [
            "run",
            "--engine",
            "naive",
            "--n-bodies",
            "64",
            "--steps",
            "2",
            "--load-init",
            str(tmp_path),
            "--output-dir",
            str(tmp_path),
        ]
    )
    assert rc == 0
    assert "Loaded 64 bodies from text files." in capsys.readouterr().out


def test_compare_engines_verdicts(tmp_path, capsys):
    """The checkEqual workflow (project.cu:1070-1092): two engines, one
    init, verdict lines (project.cu:1042-1046 strings)."""
    common = ["compare", "--n-bodies", "96", "--steps", "3", "--seed", "3"]
    # f64 native C++ vs f64 Python oracle: bit-faithful pair, 1e-10 passes
    rc = main(common + ["--engine-a", "native", "--engine-b", "oracle"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "The final positions are the same." in out
    assert "total computation took" in out

    # f32 device engine vs f64 oracle at the reference's f64 tolerance: the
    # NOT-same verdict with per-row difference lines
    rc = main(common + ["--engine-a", "oracle_naive", "--engine-b", "naive"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "!!!!! The final positions are NOT the same !!!!!" in out
    assert re.search(r"Difference at index \[\d+\]\[\d+\]:", out)

    # ... and within an f32-appropriate budget they agree
    rc = main(common + ["--engine-a", "oracle_naive", "--engine-b", "naive",
                        "--tol", "1e-5"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "The final positions are the same." in out


def test_fused_honors_side_effects(tmp_path, capsys):
    """--fused must write the same positions.txt / tree dumps as the
    contract loop (savePositions every step, project.cu:909; dumps at the
    first and top-of-last step, project.cu:962-965)."""
    common = [
        "run", "--engine", "naive", "--n-bodies", "64", "--steps", "3",
        "--seed", "5", "--save-positions", "--save-tree-dumps",
    ]
    loop_dir = tmp_path / "loop"
    fused_dir = tmp_path / "fused"
    assert main(common + ["--output-dir", str(loop_dir)]) == 0
    assert main(common + ["--output-dir", str(fused_dir), "--fused"]) == 0
    capsys.readouterr()
    for name in ("positions.txt", "quadtree_init.txt", "quadtree_final.txt"):
        a = (loop_dir / name).read_text()
        b = (fused_dir / name).read_text()
        assert a == b, f"{name} differs between loop and fused runs"


def test_fused_warns_on_unsupported(tmp_path, capsys):
    rc = main([
        "run", "--engine", "naive", "--n-bodies", "64", "--steps", "2",
        "--fused", "--checkpoint-every", "1", "--output-dir", str(tmp_path),
    ])
    assert rc == 0
    err = capsys.readouterr().err
    assert "--checkpoint-every" in err and "ignored under --fused" in err


def test_sweep_strong_format(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc = main(
        [
            "sweep",
            "--experiment",
            "strong",
            "--engine",
            "naive",
            "--n-bodies",
            "64",
            "--steps",
            "2",
            "--repeats",
            "2",
            "--device-counts",
            "1,2",
            "--results-file",
            "res.txt",
        ]
    )
    assert rc == 0
    text = open("res.txt").read()
    lines = text.splitlines()
    assert lines[0].startswith("n_bodies, n_threads, n_simulations")
    # parse exactly like plot_first_scale.py: config lines set the thread
    # context, timing lines attach to it
    parallel_times = {}
    last_thread = None
    for line in lines:
        if "n_bodies" in line.lower():
            continue
        m = CONFIG_RE.search(line)
        if m:
            last_thread = int(m.group(2))
            continue
        m = PARALLEL_RE.search(line)
        if m and last_thread is not None:
            parallel_times.setdefault(last_thread, []).append(
                int(m.group(1))
            )
    assert set(parallel_times) == {1, 2}
    assert all(len(v) == 2 for v in parallel_times.values())


def test_sweep_bodies_format(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc = main(
        [
            "sweep",
            "--experiment",
            "bodies",
            "--engine",
            "naive",
            "--steps",
            "2",
            "--repeats",
            "1",
            "--body-counts",
            "32,64",
            "--results-file",
            "res2.txt",
        ]
    )
    assert rc == 0
    lines = open("res2.txt").read().splitlines()
    # plot_second_scale.py:19 five-field config regex
    configs = [m for l in lines if (m := CONFIG5_RE.search(l))]
    assert {int(m.group(1)) for m in configs} == {32, 64}


@pytest.mark.slow
def test_sweep_unreachable_devices_warn_and_bootstrap(
    tmp_path, capsys, monkeypatch
):
    """With ``--fake-mesh always`` the sweep bootstraps onto a fake CPU
    mesh wide enough for every requested count, labeling the results
    file with the backend."""
    monkeypatch.chdir(tmp_path)
    rc = main(
        [
            "sweep", "--experiment", "strong", "--engine", "naive",
            "--n-bodies", "64", "--steps", "1", "--repeats", "1",
            "--device-counts", "1,16",  # conftest fakes 8 devices
            "--fake-mesh", "always",
            "--results-file", "res_boot.txt",
        ]
    )
    assert rc == 0
    err = capsys.readouterr().err
    assert "re-executing on a fake 16-device CPU mesh" in err
    lines = open("res_boot.txt").read().splitlines()
    threads = {
        int(m.group(2)) for l in lines if (m := CONFIG_RE.search(l))
    }
    assert threads == {1, 16}
    assert any(l.startswith("# backend:") and "fake" in l for l in lines)


def test_sweep_fake_mesh_never_filters_loudly(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc = main(
        [
            "sweep", "--experiment", "strong", "--engine", "naive",
            "--n-bodies", "64", "--steps", "1", "--repeats", "1",
            "--device-counts", "1,16", "--fake-mesh", "never",
            "--results-file", "res_never.txt",
        ]
    )
    # missing devices are an error, never silently dropped or faked
    assert rc == 2
    err = capsys.readouterr().err
    assert "ERROR: requested device counts [16]" in err
    assert "--fake-mesh always" in err
    assert not (tmp_path / "res_never.txt").exists()


@pytest.mark.slow
def test_sweep_intra_chip_axis(tmp_path, capsys, monkeypatch):
    """--sweep-axis group-chunk yields a processor-count-style multi-point
    curve on ONE device in the plot_first_scale.py format (the reference's
    N_THREADS-as-independent-variable experiment, project.cu:983)."""
    monkeypatch.chdir(tmp_path)
    rc = main(
        [
            "sweep", "--experiment", "strong", "--engine", "barnes_hut",
            "--n-bodies", "128", "--steps", "1", "--repeats", "2",
            "--sweep-axis", "group-chunk", "--axis-values", "1,2",
            "--group-size", "64", "--frontier-cap", "128",
            "--results-file", "res_axis.txt",
        ]
    )
    assert rc == 0
    lines = open("res_axis.txt").read().splitlines()
    parallel_times = {}
    last_thread = None
    for line in lines:
        if "n_bodies" in line.lower():
            continue
        m = CONFIG_RE.search(line)
        if m:
            last_thread = int(m.group(2))
            continue
        m = PARALLEL_RE.search(line)
        if m and last_thread is not None:
            parallel_times.setdefault(last_thread, []).append(
                int(m.group(1))
            )
    assert set(parallel_times) == {1, 2}
    assert all(len(v) == 2 for v in parallel_times.values())
    # tiles axis demands the allpairs engine
    with pytest.raises(SystemExit):
        main(
            [
                "sweep", "--engine", "barnes_hut", "--sweep-axis", "tiles",
                "--n-bodies", "64", "--steps", "1", "--repeats", "1",
                "--results-file", "res_bad.txt",
            ]
        )


def test_plot_subcommand(tmp_path, capsys, monkeypatch):
    """Vectorised plot subcommand renders trajectory + quadtree PNGs."""
    monkeypatch.chdir(tmp_path)
    rc = main([
        "run", "--engine", "barnes_hut", "--n-bodies", "64", "--steps", "2",
        "--save-positions", "--save-tree-dumps", "--output-dir", ".",
        "--frontier-cap", "128", "--group-chunk" if False else "--seed", "1",
    ])
    assert rc == 0
    capsys.readouterr()
    assert main(["plot", "--positions", "positions.txt"]) == 0
    assert main(["plot", "--quadtree", "quadtree_init.txt"]) == 0
    assert os.path.exists("plot_2d.png")
    assert os.path.exists("quadtree_init_png.png")
    assert main(["plot"]) == 2  # nothing to plot


@pytest.mark.slow
def test_init_mode_blobs(tmp_path, capsys):
    """--init-mode blobs: two dense clusters inside the domain, run end
    to end through the grouped engine (the collapsed worst case the
    traversal caps are calibrated against)."""
    import numpy as np

    from nbody.config import SimConfig
    from nbody.rng import random_state

    cfg = SimConfig(n_bodies=2048, init_mode="blobs", seed=3)
    state = random_state(cfg)
    pos = np.asarray(state.positions)
    assert pos.min() >= -0.1 and pos.max() <= 0.1
    # two tight clusters: the distance of each body to its nearer
    # cluster mean is a few sigma (sigma = 2% of the 0.2 range)
    c0 = pos[0::2].mean(0)
    c1 = pos[1::2].mean(0)
    d = np.minimum(
        np.linalg.norm(pos - c0, axis=1), np.linalg.norm(pos - c1, axis=1)
    )
    assert np.quantile(d, 0.99) < 0.02  # ~5 sigma
    assert np.linalg.norm(c0 - c1) > 0.01  # distinct clusters

    rc = main(
        [
            "run", "--engine", "barnes_hut", "--init-mode", "blobs",
            "--n-bodies", "2048", "--steps", "2",
            "--output-dir", str(tmp_path),
        ]
    )
    assert rc == 0
    assert TOTAL_RE.search(capsys.readouterr().out)


def test_plot_scaling_analysis(tmp_path, monkeypatch, capsys):
    """plot --analysis emits the reference's mean/speedup/efficiency
    analyses (plot_first_scale.py:105-154) from a strong-scaling results
    file, and the runtime-vs-N errorbar plot (plot_second_scale.py:58-88)
    from a bodies sweep."""
    import os

    monkeypatch.chdir(tmp_path)
    strong = []
    for p, us in [(1, 8000), (1, 8200), (2, 4500), (2, 4300),
                  ("1024*2", 300)]:
        strong.append(f"64, {p}, 2, run")
        strong.append(f"GPU parallel computation took {us} microseconds.")
        strong.append("GPU total computation took 12 milliseconds.")
    open("strong.txt", "w").write("\n".join(strong) + "\n")
    assert main(["plot", "--analysis", "strong.txt"]) == 0
    for suffix in ("runtime", "speedup", "efficiency"):
        assert os.path.exists(f"strong_{suffix}.png"), suffix

    from nbody.bench.plots import _parse_scaling_results

    records, ns = _parse_scaling_results("strong.txt")
    # the reference parser's product thread syntax (plot_first_scale.py:103)
    assert (64, 2048, 300.0, 12.0) in records

    bodies = []
    for n, us in [(32, 100), (64, 410), (64, 390)]:
        bodies.append(f"{n}, 1, 2, 1, run")
        bodies.append(f"GPU parallel computation took {us} microseconds.")
    open("bodies.txt", "w").write("\n".join(bodies) + "\n")
    assert main(["plot", "--analysis", "bodies.txt"]) == 0
    assert os.path.exists("bodies_runtime_vs_n.png")


@pytest.mark.slow
def test_fused_run_warns_on_overflow(tmp_path, capsys):
    """The fused CLI path must print the same overflow warning the
    contract loop does (round-3 weak #6 done-criterion): a deliberately
    under-capped --fused run reports per-step counts and says fused runs
    don't retry."""
    rc = main([
        "run", "--engine", "barnes_hut", "--n-bodies", "2048",
        "--steps", "2", "--seed", "5", "--frontier-cap", "32",
        "--group-size", "256", "--fused", "--output-dir", str(tmp_path),
    ])
    assert rc == 0
    err = capsys.readouterr().err
    assert "overflowed" in err
    assert "fused runs do NOT retry" in err
