"""Scaling-experiment sweeps (the reference's L7 layer, without recompiles).

Reproduces the two protocols:

* strong scaling — fixed problem size, vary processor count
  (first_scaling_script.sh: 40,000 bodies, threads 1..40,000, 5 repeats,
  10 steps).  Processors here are chips on the dp mesh — or, with
  ``--sweep-axis group-chunk|tiles``, an *intra-chip* parallelism
  granularity, the moral equivalent of the reference's N_THREADS axis
  (its grid is sized from N_THREADS precisely so processor count is an
  independent variable, project.cu:983) observable on a single chip.
* weak scaling — problem size per processor fixed
  (second_scaling_script.sh: bodies=threads 1:1).
* bodies — vary N on fixed devices (the reference's weak-scaling axis as
  observable on a single chip).

Results-file format matches the scripts' output consumed by
plot_first_scale.py / plot_second_scale.py: a header, then per run a
``n_bodies, n_threads, n_simulations[, repetition], <program stdout>``
block where the timing lines ("GPU parallel computation took ... ") appear
verbatim (first_scaling_script.sh:14-15,36; second_scaling_script.sh:13,39).
A trailing ``# backend: ...`` label line records where the sweep ran
(ignored by the reference parsers, which match config/timing regexes only).

Device counts beyond the visible device count are an error, never
silently dropped or replaced.  ``--fake-mesh always`` runs the sweep
instead in a subprocess on a fake CPU mesh wide enough for every requested
count, labeling the results accordingly: fake-mesh numbers measure
protocol correctness, not hardware scaling.
"""

from __future__ import annotations

import io
import os
import sys
from contextlib import redirect_stdout
from typing import List

_BOOTSTRAP_ENV = "NBODY_SWEEP_BOOTSTRAPPED"

AXIS_DEFAULTS = {
    "group-chunk": "1,2,4,8,16,32",
    "tiles": "64,128,256,512",
}


def _run_one(config, state, step_fn):
    """One timed run; returns the program stdout text (timing lines)."""
    from ..models.simulation import Simulation

    sim = Simulation(config, state=state, step_fn=step_fn)
    buf = io.StringIO()
    with redirect_stdout(buf):
        _, timing = sim.run_contract()
        print()
        print(timing.total_line())
        print()
        print(timing.parallel_line())
    return buf.getvalue()


def _fresh_state(config, seed):
    from ..rng import random_state

    return random_state(config.replace(seed=seed))


def _base_config(args):
    from ..config import SimConfig

    return SimConfig(
        n_bodies=args.n_bodies,
        n_dim=getattr(args, "dims", 2),
        n_steps=args.steps,
        dt=args.dt,
        g=args.g,
        engine=args.engine,
        theta=args.theta,
        max_depth=args.max_depth,
        softening=args.softening,
        bh_mode=args.bh_mode,
        group_size=args.group_size,
        dtype=args.precision,
        target_block=args.target_block,
        source_block=args.source_block,
        frontier_cap=args.frontier_cap,
    )


def _write_results(path, lines, backend_label):
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
        f.write(f"# backend: {backend_label}\n")
    print(f"results written to {path}", file=sys.stderr)


def _bootstrap_fake_mesh(args, n_devices: int) -> int:
    """Re-exec this sweep in a subprocess on a fake CPU mesh wide enough
    for every requested device count (XLA_FLAGS must be set before jax
    initialises, hence the subprocess)."""
    import subprocess

    argv = getattr(args, "argv_raw", None)
    if argv is None:
        raise RuntimeError(
            "cannot re-exec sweep: original argv unavailable "
            "(call nbody.cli.main directly or pass --fake-mesh never)"
        )
    import re

    env = dict(os.environ)
    # replace (not append-if-absent): the parent may already force a
    # smaller fake mesh via XLA_FLAGS
    flags = re.sub(
        r"--xla_force_host_platform_device_count=\d+",
        "",
        env.get("XLA_FLAGS", ""),
    ).strip()
    env["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={n_devices}"
    ).strip()
    env[_BOOTSTRAP_ENV] = "1"
    # the child must resolve nbody the same way the parent did —
    # the parent's cwd/sys.path don't transfer (a sweep launched from
    # any other directory failed the re-exec with ModuleNotFoundError)
    pkg_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    env["PYTHONPATH"] = os.pathsep.join(
        [pkg_root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "import sys\n"
        "from nbody.cli import main\n"
        f"sys.exit(main({argv!r}))\n"
    )
    print(
        f"sweep: re-executing on a fake {n_devices}-device CPU mesh "
        "(results labeled; protocol correctness, not hardware scaling)",
        file=sys.stderr,
    )
    proc = subprocess.run([sys.executable, "-c", code], env=env)
    return proc.returncode


def _run_intra_chip_sweep(args, axis: str) -> int:
    """Processor-count-style curve on ONE device: the axis value plays
    the reference's N_THREADS role in the results file."""
    values = [
        int(x)
        for x in (args.axis_values or AXIS_DEFAULTS[axis]).split(",")
    ]
    if axis == "tiles" and args.engine != "allpairs":
        raise SystemExit(
            "--sweep-axis tiles varies the all-pairs target block; "
            "use --engine allpairs"
        )
    if axis == "group-chunk" and args.engine != "barnes_hut":
        raise SystemExit(
            "--sweep-axis group-chunk varies the grouped-BH evaluation "
            "batch; use --engine barnes_hut"
        )
    base = _base_config(args)
    lines: List[str] = [
        "n_bodies, n_threads, n_simulations, runtime"
    ]
    for v in values:
        cfg = (
            base.replace(group_chunk=v)
            if axis == "group-chunk"
            else base.replace(target_block=v)
        )
        for rep in range(1, args.repeats + 1):
            state = _fresh_state(cfg, seed=args.seed + rep)
            stdout = _run_one(cfg, state, None)
            lines.append(f"{args.n_bodies}, {v}, {args.steps}, " + stdout)
            print(
                f"{axis}: value={v} rep={rep} done", file=sys.stderr
            )
    import jax

    _write_results(
        args.results_file,
        lines,
        f"{jax.default_backend()} single-device, axis={axis}",
    )
    return 0


def run_sweep(args) -> int:
    import jax

    from .. import parallel
    from ..config import MeshConfig

    axis = getattr(args, "sweep_axis", "devices")
    if axis != "devices":
        return _run_intra_chip_sweep(args, axis)

    base = _base_config(args)

    if args.device_counts:
        device_counts = [int(x) for x in args.device_counts.split(",")]
    else:
        device_counts = [1, 2, 4, 8]
    if args.body_counts:
        body_counts = [int(x) for x in args.body_counts.split(",")]
    else:
        # second_scaling_script.sh:4 body axis
        body_counts = [2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048,
                       4096, 8192, 16384, 32768, 40000]

    wanted_max = (
        max(device_counts)
        if args.experiment in ("strong", "weak")
        else args.devices
    )
    if (
        getattr(args, "fake_mesh", "never") == "always"
        and not os.environ.get(_BOOTSTRAP_ENV)
    ):
        return _bootstrap_fake_mesh(args, max(8, wanted_max))
    visible = jax.device_count()
    if wanted_max > visible:
        print(
            f"ERROR: requested device counts "
            f"{[d for d in device_counts if d > visible] or [wanted_max]} "
            f"exceed the {visible} visible device(s); pass --fake-mesh "
            "always to check the protocol on a fake CPU mesh",
            file=sys.stderr,
        )
        return 2

    out_path = args.results_file
    header = (
        "n_bodies, n_threads, n_simulations, repetition, runtime"
        if args.experiment in ("weak", "bodies")
        else "n_bodies, n_threads, n_simulations, runtime"
    )
    lines: List[str] = [header]

    def one_point(n_bodies, n_devices, rep):
        cfg = base.replace(
            n_bodies=n_bodies, mesh=MeshConfig(dp=n_devices)
        )
        state = _fresh_state(cfg, seed=args.seed + rep)
        step_fn = None
        if n_devices > 1:
            if args.engine == "barnes_hut":
                mode = (
                    "dp_barnes_hut_grouped3"
                    if getattr(args, "dims", 2) == 3
                    else "dp_barnes_hut_grouped"
                )
            else:
                mode = "dp_allpairs"
            mesh = parallel.make_mesh(n_devices)
            state = parallel.shard_state(state, mesh)
            step_fn = parallel.make_sharded_step(cfg, mesh, mode)
        return _run_one(cfg, state, step_fn)

    if args.experiment == "strong":
        for n_dev in device_counts:
            for rep in range(1, args.repeats + 1):
                stdout = one_point(args.n_bodies, n_dev, rep)
                lines.append(
                    f"{args.n_bodies}, {n_dev}, {args.steps}, " + stdout
                )
                print(
                    f"strong: devices={n_dev} rep={rep} done",
                    file=sys.stderr,
                )
    elif args.experiment == "weak":
        per_device = args.n_bodies
        for rep_i, n_dev in enumerate(device_counts):
            for rep in range(1, args.repeats + 1):
                n_bodies = per_device * n_dev
                stdout = one_point(n_bodies, n_dev, rep)
                lines.append(
                    f"{n_bodies}, {n_dev}, {args.steps}, {rep}, " + stdout
                )
                print(
                    f"weak: devices={n_dev} N={n_bodies} rep={rep} done",
                    file=sys.stderr,
                )
    else:  # bodies
        for n_bodies in body_counts:
            for rep in range(1, args.repeats + 1):
                stdout = one_point(n_bodies, args.devices, rep)
                lines.append(
                    f"{n_bodies}, {args.devices}, {args.steps}, {rep}, "
                    + stdout
                )
                print(
                    f"bodies: N={n_bodies} rep={rep} done", file=sys.stderr
                )

    backend = jax.default_backend()
    label = f"{backend}-{visible}-device-mesh"
    if os.environ.get(_BOOTSTRAP_ENV):
        label = f"cpu-fake-{visible}-device-mesh (protocol validation)"
    _write_results(out_path, lines, label)
    return 0
