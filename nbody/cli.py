"""Command-line interface.

Replaces the reference's configuration workflow — compile-time ``#define``s
(project.cu:1-11), ``-D`` recompiles per sweep point
(first_scaling_script.sh:30), and mode selection by (un)commenting lines in
``main`` (project.cu:1061-1066, README.md:14-18) — with runtime flags.

Subcommands:

* ``run``   — one simulation; prints the reference's stdout timing contract
  (the exact lines parsed by plot_first_scale.py:58-59).
* ``sweep`` — strong/weak scaling protocols; appends results in the
  scaling-scripts' file format so the reference's plot_first_scale.py /
  plot_second_scale.py run unchanged.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--n-bodies", type=int, default=1024)
    p.add_argument("--dims", type=int, choices=[2, 3], default=2,
                   help="spatial dimensions: 2 = reference parity "
                        "(N_DIM=2, project.cu:28); 3 = the octree "
                        "generalisation its report names "
                        "(project_report.pdf p.8)")
    p.add_argument("--steps", type=int, default=10,
                   help="N_SIMULATIONS analogue (project.cu:9-11)")
    p.add_argument("--dt", type=float, default=1.0)
    p.add_argument("--g", type=float, default=6.67e-11)
    p.add_argument(
        "--engine",
        choices=["naive", "allpairs", "barnes_hut"],
        default="barnes_hut",
    )
    p.add_argument("--theta", type=float, default=0.5)
    p.add_argument("--max-depth", type=int, default=None,
                   help="tree depth cap; default: 9 in 2D (reference QUADTREE_MAX_DEPTH, project.cu:61), density-derived in 3D")
    p.add_argument("--softening", type=float, default=1e-15,
                   help="distance softening (project.cu:634; naive uses 0)")
    p.add_argument("--bh-mode", choices=["grouped", "exact"],
                   default="grouped")
    p.add_argument("--group-size", type=int, default=None,
                   help="Morton group size (default auto: 2048, except "
                        "4096 for 3D N in [256K, 768K); "
                        "bh3d.default_group_size3)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--precision", choices=["float32", "float64", "bfloat16"],
                   default="float32")
    p.add_argument("--compensated", action="store_true",
                   help="Kahan-compensated accumulation across source "
                        "tiles in the all-pairs kernel (lower f32 error "
                        "floor)")
    p.add_argument("--target-block", type=int, default=None,
                   help="all-pairs kernel targets per program (default: "
                        "the kernel's, chosen on the card)")
    p.add_argument("--source-block", type=int, default=None,
                   help="all-pairs kernel sources per loop iteration "
                        "(default: the kernel's, chosen on the card)")
    p.add_argument("--frontier-cap", type=int, default=None,
                   help="BH traversal capacity (default: auto — grouped "
                        "mode derives a per-level schedule from measured "
                        "demand; exact mode uses 256)")
    p.add_argument("--collect3", choices=["auto", "gather", "dense"],
                   default=None,
                   help="3D list-collection traversal (default auto: "
                        "dense window-stencil slabs at N >= 256K, the "
                        "gather frontier walk below; "
                        "ops/collect_dense3.py)")
    p.add_argument("--no-adaptive-caps", action="store_true",
                   help="disable the overflow retry (by default an "
                        "overflowed step is recomputed with 4x caps; "
                        "disabled = the reference's warn-only behavior)")
    # init modes (README.md:14-18: CPU init / GPU init / load from files)
    p.add_argument("--init-mode", choices=["uniform", "blobs"],
                   default="uniform",
                   help="random init distribution: uniform (reference) "
                        "or blobs (two dense clusters — the collapsed "
                        "worst case the traversal caps are calibrated "
                        "against)")
    p.add_argument("--load-init", metavar="DIR", default=None,
                   help="load masses/positions/velocities_init.txt from DIR")
    p.add_argument("--save-init", action="store_true",
                   help="save the init triplet to the output dir")
    p.add_argument("--save-positions", action="store_true",
                   help="write per-step positions.txt (plot_2d.py input)")
    p.add_argument("--save-tree-dumps", action="store_true",
                   help="write quadtree_{init,final}.txt (plot_quadtree.py)")
    p.add_argument("--output-dir", default=".")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--metrics-csv", default=None, metavar="FILE",
                   help="per-step energy/momentum/tree-stats CSV")
    p.add_argument("--no-metrics-tree", action="store_true",
                   help="skip per-step tree statistics in the metrics CSV "
                        "(they rebuild the pyramid once per step)")
    p.add_argument("--check-overflow", action="store_true",
                   help="barnes_hut: run one diagnostic force pass before "
                        "the simulation and warn if any traversal/list cap "
                        "overflowed (the stack-guard printf analogue, "
                        "project.cu:712-721)")
    p.add_argument("--fused", action="store_true",
                   help="run the whole step loop as one compiled program "
                        "(lax.scan; no per-step host sync or file capture)")
    p.add_argument("--resume", metavar="NPZ", default=None,
                   help="resume from a checkpoint file")
    # parallelism
    p.add_argument("--devices", type=int, default=1,
                   help="number of cards (bodies sharded over a dp mesh)")
    p.add_argument(
        "--mode",
        choices=["auto", "dp_allpairs", "ring_allpairs", "dp_barnes_hut",
                 "dp_barnes_hut_grouped", "dp_barnes_hut_sharded",
                 "dp_barnes_hut_grouped3", "dp_barnes_hut_sharded3",
                 "dp2d_allpairs"],
        default="auto",
        help="sharded step selection when --devices > 1",
    )
    p.add_argument(
        "--hbm-gb", type=float, default=None,
        help="per-card memory (GiB) for the --mode auto grouped-vs-sharded "
             "gate (default: the card's own limit; parallel/memory.py)",
    )


def _build_config(args):
    from .config import SimConfig, MeshConfig

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
        seed=args.seed,
        init_mode=getattr(args, "init_mode", "uniform"),
        dtype=args.precision,
        compensated=args.compensated,
        target_block=args.target_block,
        source_block=args.source_block,
        frontier_cap=args.frontier_cap,
        collect3=getattr(args, "collect3", None),
        adaptive_caps=not args.no_adaptive_caps,
        save_positions=args.save_positions,
        save_tree_dumps=args.save_tree_dumps,
        output_dir=args.output_dir,
        checkpoint_every=args.checkpoint_every,
        metrics_csv=args.metrics_csv,
        metrics_tree=not args.no_metrics_tree,
        mesh=MeshConfig(dp=args.devices),
        hbm_bytes=(
            int(args.hbm_gb * 1024**3)
            if getattr(args, "hbm_gb", None)
            else None
        ),
    )


def _make_state(args, config):
    from .rng import random_state
    from .state import make_state

    if args.resume:
        from .utils.checkpoint import load_checkpoint

        return load_checkpoint(args.resume, dtype=config.jnp_dtype())
    if args.load_init:
        from .utils.textio import load_init_triplet

        m, p, v = load_init_triplet(
            os.path.join(args.load_init, "masses_init.txt"),
            os.path.join(args.load_init, "positions_init.txt"),
            os.path.join(args.load_init, "velocities_init.txt"),
            args.n_bodies,
            n_dim=getattr(args, "dims", 2),
        )
        return make_state(m, p, v, dtype=config.jnp_dtype())
    return random_state(config)


def cmd_run(args) -> int:
    config = _build_config(args)
    state = _make_state(args, config)

    if args.save_init:
        from .utils.textio import save_init_triplet

        os.makedirs(args.output_dir, exist_ok=True)
        save_init_triplet(
            args.output_dir,
            np.asarray(state.masses),
            np.asarray(state.positions),
            np.asarray(state.velocities),
        )

    step_fn = None
    step_fallback_fn = None
    if args.devices > 1:
        from .parallel import make_mesh, make_mesh_2d, make_sharded_step, shard_state

        mode = args.mode
        if mode == "auto":
            if args.engine == "barnes_hut":
                # HBM-fit gate: grouped (full replication, fastest) vs
                # sharded (O(N/devices) sources) — parallel/memory.py,
                # the reference's 48KB-gate decision logic at HBM scale
                from .parallel.memory import choose_bh_mode

                # hbm_bytes resolves from config.hbm_bytes (--hbm-gb)
                mode = choose_bh_mode(config, args.devices, verbose=True)
            else:
                mode = "dp_allpairs"
        if getattr(args, "dims", 2) == 3 and mode in (
            "dp_barnes_hut", "dp_barnes_hut_grouped"
        ):
            print(
                f"ERROR: --mode {mode} is 2D-only; use "
                "dp_barnes_hut_grouped3 (or --mode auto) for 3D",
                file=sys.stderr,
            )
            return 2
        if mode == "dp2d_allpairs":
            mesh = make_mesh_2d(max(args.devices // 2, 1), 2)
        else:
            mesh = make_mesh(args.devices)
            state = shard_state(state, mesh)
        step_fn = make_sharded_step(config, mesh, mode)
        if "barnes_hut" in mode:
            # adaptive-caps retry for the sharded tree modes: same 4x
            # policy as the single-chip loop (the overflow count is
            # psum'd inside the step and rides in state.overflow)
            def step_fallback_fn(_mesh=mesh, _mode=mode):
                from .models.engines import resolved_caps

                caps = {
                    k: 4 * v for k, v in resolved_caps(config).items()
                }
                return make_sharded_step(
                    config.replace(**caps), _mesh, _mode
                )

    from .models.simulation import Simulation

    os.makedirs(args.output_dir, exist_ok=True)
    sim = Simulation(
        config, state=state, step_fn=step_fn,
        step_fallback_fn=step_fallback_fn,
    )

    if args.check_overflow and args.engine == "barnes_hut" and args.devices == 1:
        # Diagnose the engine that will actually run: dispatch on bh_mode
        # with the engine's own cap configuration (make_accel_fn), not a
        # fixed grouped call — exact mode uses the raw frontier_cap with
        # different overflow behavior.
        import numpy as _np

        from .models.engines import make_accel_fn

        diag_fn = make_accel_fn(config, return_diagnostics=True)
        _, ovf = diag_fn(sim.state.positions, sim.state.masses)
        n_ovf = int(_np.asarray(ovf).sum())
        if n_ovf:
            print(
                f"WARNING: traversal caps overflowed for {n_ovf} bodies "
                "at step 0; raise --frontier-cap / list/direct caps "
                "(forces for flagged bodies drop interactions)",
                file=sys.stderr,
            )
    if args.fused:
        import time as _time

        import jax

        from .utils.timing import RunTiming

        # per-step host side effects that genuinely cannot run inside one
        # compiled scan — warn loudly instead of silently dropping them
        unsupported = []
        if args.checkpoint_every:
            unsupported.append("--checkpoint-every")
        if args.metrics_csv:
            unsupported.append("--metrics-csv")
        if unsupported:
            print(
                f"WARNING: {', '.join(unsupported)} ignored under --fused "
                "(needs per-step host sync); rerun without --fused for "
                "those outputs",
                file=sys.stderr,
            )

        capture = args.save_positions or args.save_tree_dumps
        if args.save_tree_dumps:
            sim._dump_tree(sim.state, first=True)

        if capture:
            # trajectory captured on-device inside the scan (stacked
            # [steps+1, N, 2]), written in one host pass afterwards —
            # savePositions-every-step semantics (project.cu:909) without
            # per-step crossings
            t0_time = float(sim.state.time)
            compiled = sim._scan_traj.lower(
                sim.state, config.n_steps
            ).compile()
            t0 = _time.perf_counter()
            final, traj, scan_ovf = compiled(sim.state)
            jax.block_until_ready(traj)
            elapsed = _time.perf_counter() - t0
            sim.state = final
            sim._report_scan_overflow(scan_ovf)

            if args.save_positions:
                from .utils.textio import PositionsWriter

                writer = PositionsWriter(
                    os.path.join(args.output_dir, "positions.txt")
                )
                traj_np = np.asarray(traj)
                for k in range(traj_np.shape[0]):
                    writer.append(t0_time + k * config.dt, traj_np[k])
                writer.flush()
            if args.save_tree_dumps:
                # the reference dumps the final tree at the TOP of the
                # last step (project.cu:962-965), i.e. after n-1 updates
                sim._dump_tree(
                    final, first=False, positions=traj[config.n_steps - 1]
                )
        else:
            # compile outside the clock, then one fully-fused program
            compiled = sim._scan_steps.lower(
                sim.state, config.n_steps
            ).compile()
            t0 = _time.perf_counter()
            final, scan_ovf = compiled(sim.state)
            jax.block_until_ready(final.positions)
            elapsed = _time.perf_counter() - t0
            sim.state = final
            sim._report_scan_overflow(scan_ovf)
        timing = RunTiming(total_ms=elapsed * 1e3,
                           parallel_us=elapsed * 1e6)
    else:
        _, timing = sim.run_contract()
    print()
    # the machine-readable contract lines (project.cu:1097/1102)
    print(timing.total_line())
    print()
    print(timing.parallel_line())
    return 0


_COMPARE_ENGINES = (
    "naive", "allpairs", "barnes_hut",
    "native", "native_naive", "oracle", "oracle_naive",
)


def _run_engine_final(name: str, config, state0) -> np.ndarray:
    """Run ``n_steps`` of one engine from a fixed init; return final
    positions [N, 2] (float64 for the host engines, the configured dtype
    for the device engines)."""
    m = np.asarray(state0.masses, np.float64)
    p = np.asarray(state0.positions, np.float64)
    v = np.asarray(state0.velocities, np.float64)

    if name in ("native", "native_naive"):
        from .utils import native

        pos, _ = native.simulate(
            p, v, m, config.n_steps, config.dt, config.g,
            engine="naive" if name == "native_naive" else "barnes_hut",
            theta=config.theta, max_depth=config.resolved_max_depth,
        )
        return pos
    if name in ("oracle", "oracle_naive"):
        from .models import oracle

        return oracle.simulate(
            p, v, m, config.n_steps, dt=config.dt, g=config.g,
            engine="naive" if name == "oracle_naive" else "barnes_hut",
            theta=config.theta, max_depth=config.resolved_max_depth,
        )[-1]

    from .models.simulation import Simulation
    from .state import make_state

    sim = Simulation(
        config.replace(
            engine=name,
            save_positions=False,
            save_tree_dumps=False,
            metrics_csv=None,
            checkpoint_every=0,
        ),
        state=make_state(m, p, v, dtype=config.jnp_dtype()),
    )
    sim.run_scan()
    return np.asarray(sim.state.positions, np.float64)


def cmd_compare(args) -> int:
    """The reference's verification-by-comparison workflow
    (project.cu:1049-1105): run two engines from ONE initial condition and
    print the checkEqual verdict (project.cu:1027-1047).

    Unlike the reference's main (which reuses the mutated velocity array
    between the CPU and GPU runs), both engines start from identical
    (masses, positions, velocities)."""
    import time as _time

    config = _build_config(args)
    if getattr(args, "dims", 2) == 3:
        host_only = {"native", "native_naive", "oracle", "oracle_naive"}
        used = {args.engine_a, args.engine_b} & host_only
        if used:
            print(
                f"ERROR: {', '.join(sorted(used))} are 2D-only host "
                "engines (the reference and its oracle are N_DIM=2); in "
                "3D compare e.g. --engine-a naive --engine-b barnes_hut",
                file=sys.stderr,
            )
            return 2
    state0 = _make_state(args, config)

    from .utils.textio import check_equal

    finals = []
    for name in (args.engine_a, args.engine_b):
        t0 = _time.perf_counter()
        finals.append(_run_engine_final(name, config, state0))
        ms = (_time.perf_counter() - t0) * 1e3
        print(f"{name} total computation took {ms:.0f} milliseconds.")

    print()
    equal = check_equal(
        finals[0], finals[1], "final positions", tol=args.tol
    )
    print()
    return 0 if equal else 1


def cmd_sweep(args) -> int:
    from .bench.sweeps import run_sweep

    return run_sweep(args)


def cmd_plot(args) -> int:
    from .bench import plots

    if args.positions:
        print(plots.trajectories(args.positions, args.out))
    if args.positions_3d:
        print(plots.trajectories_3d(args.positions_3d, args.out))
    if args.quadtree:
        print(plots.quadtree(args.quadtree, args.out))
    if args.analysis:
        for png in plots.scaling_analysis(
            args.analysis, args.out, metric=args.metric
        ):
            print(png)
    if not (args.positions or args.quadtree or args.positions_3d
            or args.analysis):
        print(
            "nothing to plot: pass --positions, --positions-3d, "
            "--quadtree and/or --analysis"
        )
        return 2
    return 0


def cmd_bench(args) -> int:
    """The headline benchmark metric (also: repo-root bench.py)."""
    from .bench.headline import main as bench_main

    return bench_main()


def main(argv=None) -> int:
    raw = list(argv) if argv is not None else list(sys.argv[1:])
    parser = argparse.ArgumentParser(
        prog="nbody",
        description="gravitational N-body framework (JAX, NVIDIA GPU)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_run = sub.add_parser("run", help="run one simulation")
    _add_common(p_run)
    p_run.set_defaults(fn=cmd_run)

    p_sweep = sub.add_parser(
        "sweep", help="strong/weak scaling experiment sweeps"
    )
    _add_common(p_sweep)
    p_sweep.add_argument(
        "--experiment",
        choices=["strong", "weak", "bodies"],
        default="strong",
        help="strong: fixed N, vary devices (first_scaling_script.sh "
        "analogue); weak: N per device fixed, vary devices; bodies: vary N "
        "on fixed devices (second_scaling_script.sh analogue)",
    )
    p_sweep.add_argument("--repeats", type=int, default=5,
                         help="repetitions per config (scripts use 5)")
    p_sweep.add_argument("--device-counts", type=str, default="",
                         help="comma list, e.g. 1,2,4,8")
    p_sweep.add_argument("--body-counts", type=str, default="",
                         help="comma list for --experiment bodies")
    p_sweep.add_argument("--results-file", default="scaling_results.txt")
    p_sweep.add_argument(
        "--sweep-axis",
        choices=["devices", "group-chunk", "tiles"],
        default="devices",
        help="processor axis: cards on the dp mesh (default), or an "
        "intra-chip granularity on ONE device — group-chunk (grouped-BH "
        "evaluation batch) or tiles (all-pairs target block) — the "
        "single-chip analogue of the reference's N_THREADS axis "
        "(project.cu:983)",
    )
    p_sweep.add_argument(
        "--axis-values", type=str, default="",
        help="comma list for --sweep-axis group-chunk|tiles "
        "(defaults: 1,2,4,8,16,32 / 64,128,256,512)",
    )
    p_sweep.add_argument(
        "--fake-mesh",
        choices=["never", "always"],
        default="never",
        help="never (default): requested device counts beyond the "
        "visible devices are an error; always: run the sweep on a fake "
        "CPU mesh (labeled results — protocol correctness, not speed)",
    )
    p_sweep.set_defaults(fn=cmd_sweep)

    p_compare = sub.add_parser(
        "compare",
        help="run two engines from one init and print the checkEqual "
        "verdict (project.cu:1027-1047 workflow)",
    )
    _add_common(p_compare)
    p_compare.add_argument(
        "--engine-a", choices=_COMPARE_ENGINES, default="native",
        help="first engine (native/oracle run the f64 host reference)",
    )
    p_compare.add_argument(
        "--engine-b", choices=_COMPARE_ENGINES, default="barnes_hut",
        help="second engine",
    )
    p_compare.add_argument(
        "--tol", type=float, default=1e-10,
        help="element tolerance (reference checkEqual uses 1e-10 for its "
        "f64-vs-f64 runs; f32 device engines vs the f64 host engines need "
        "a looser budget, e.g. 1e-5)",
    )
    p_compare.set_defaults(fn=cmd_compare)

    p_bench = sub.add_parser("bench", help="headline benchmark JSON line")
    p_bench.set_defaults(fn=cmd_bench)

    p_plot = sub.add_parser(
        "plot", help="vectorised analysis plots (large-N capable)"
    )
    p_plot.add_argument("--positions", default=None, metavar="FILE")
    p_plot.add_argument("--positions-3d", default=None, metavar="FILE",
                        help="five-column 3D positions.txt (functional "
                        "replacement for the reference's broken "
                        "plot_3d.py)")
    p_plot.add_argument("--quadtree", default=None, metavar="FILE")
    p_plot.add_argument("--analysis", default=None, metavar="FILE",
                        help="sweep results file: emit the reference's "
                        "mean-runtime / speedup / efficiency analyses "
                        "(plot_first_scale.py:105-154) or the runtime-"
                        "vs-N errorbar plot for weak/bodies sweeps "
                        "(plot_second_scale.py:58-88)")
    p_plot.add_argument("--metric", choices=["parallel", "total"],
                        default="parallel",
                        help="which timing line the analysis uses")
    p_plot.add_argument("--out", default=None)
    p_plot.set_defaults(fn=cmd_plot)

    args = parser.parse_args(argv)
    args.argv_raw = raw  # for the sweep fake-mesh re-exec
    from .device import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
