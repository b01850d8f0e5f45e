"""BASELINE.json benchmark configs as runnable scenarios.

Run: ``python -m nbody.bench.baseline [--configs 1,2,3] [--out FILE]
[--fake-mesh never|always]``

The five configs (BASELINE.json "configs"):

1. All-pairs N=1,024 from the reference's golden init triplet, 100 steps,
   fixed dt — trajectory parity vs the f64 oracle of
   main_approach_1.cpp semantics.
2. All-pairs N=16,384 brute force on one card (the all-pairs engine: the
   tiled kernel on the GPU) — throughput + force parity vs the dense XLA
   formulation.
3. Barnes-Hut theta=0.5, N=65,536 — tree build + COM aggregation +
   traversal timing, and quadtree_init/final dump writing (plot_quadtree
   format; dumps are byte-identical to the reference builder per
   tests/test_native.py).
4. Strong scaling: Barnes-Hut N=262,144 across 1..n devices.
5. Weak scaling: 131,072 bodies/device up to 1M bodies, sharded with the
   per-step all_gather.

Each config reports a JSON record.  Configs 4-5 run at the visible device
counts (1, 2, 4, 8 up to what exists); with fewer than two devices they are
an error unless ``--fake-mesh always`` asks for the labeled fake 8-device
CPU mesh (protocol correctness, not speed).  Step times are medians of
``block_until_ready``-ended calls after a warm-up call.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .headline import device_label, time_call

REF_DIR = os.environ.get(
    "NBODY_REFERENCE_DIR", "/root/reference/implementation"
)


def _step_seconds(fn, *args, reps=5):
    """Median seconds of ``fn(*args)`` after one warm-up (compile) call."""
    return time_call(fn, *args, reps=reps)[1]


def config1():
    """Golden-fixture all-pairs, 100 steps, parity vs the f64 oracle."""
    import jax.numpy as jnp

    from ..models import oracle
    from ..physics import pair_accelerations_dense
    from ..utils.textio import load_init_triplet

    n, steps, g = 1024, 100, 6.67e-11
    m, p, v = load_init_triplet(
        os.path.join(REF_DIR, "masses_init.txt"),
        os.path.join(REF_DIR, "positions_init.txt"),
        os.path.join(REF_DIR, "velocities_init.txt"),
        n,
    )
    traj = oracle.simulate(p, v, m, steps, dt=1.0, g=g, engine="naive")

    pj = jnp.asarray(p, jnp.float32)
    vj = jnp.asarray(v, jnp.float32)
    mj = jnp.asarray(m, jnp.float32)
    t0 = time.perf_counter()
    # parity horizon: N-body dynamics is chaotic, so f32-vs-f64 divergence
    # grows exponentially past close encounters; the reference records its
    # own CPU-vs-GPU runs deviating "around 45th iteration"
    # (observations.txt:43).  Parity is therefore judged at step 45 and
    # the full 100-step run is reported informationally.
    errs = {}
    for step_i in range(1, steps + 1):
        acc = pair_accelerations_dense(pj, mj, g=g)
        vj = vj + acc
        pj = pj + vj
        if step_i in (25, 45, 100):
            want_i = traj[step_i]
            scale_i = np.abs(want_i).max()
            e = np.abs(np.asarray(pj) - want_i)
            errs[step_i] = {
                "rms_rel": float(np.sqrt((e**2).mean()) / scale_i),
                "q995_rel": float(np.quantile(e, 0.995) / scale_i),
            }
    pj.block_until_ready()
    elapsed = time.perf_counter() - t0

    # The binding parity criterion runs in f64 on the CPU backend (the
    # reference is all-f64).  This is a genuinely independent implementation
    # of the same math vs the numpy oracle — the reference's own
    # checkEqual methodology (project.cu:1027-1047).
    import jax

    x64_was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        cpu = jax.devices("cpu")[0]
        f64_errs = {}
        with jax.default_device(cpu):
            p64 = jax.device_put(jnp.asarray(p, jnp.float64), cpu)
            v64 = jax.device_put(jnp.asarray(v, jnp.float64), cpu)
            m64 = jax.device_put(jnp.asarray(m, jnp.float64), cpu)
            for step_i in range(1, steps + 1):
                acc = pair_accelerations_dense(p64, m64, g=g)
                v64 = v64 + acc
                p64 = p64 + v64
                if step_i in (25, 45, 100):
                    want_i = traj[step_i]
                    scale_i = np.abs(want_i).max()
                    e64 = np.abs(np.asarray(p64) - want_i)
                    f64_errs[step_i] = float(
                        np.quantile(e64, 0.995) / scale_i
                    )
    finally:
        jax.config.update("jax_enable_x64", x64_was)

    return {
        "config": 1,
        "n": n,
        "steps": steps,
        "seconds": elapsed,
        "f32_err_by_step": errs,
        "f64_q995_rel_by_step": f64_errs,
        # Chaos bounds any cross-implementation comparison: the reference's
        # own f64 CPU-vs-GPU trajectories "start to deviate slightly around
        # 45th iteration" (observations.txt:43), and summation-order ulps
        # amplify ~e^(lambda t).  Parity is therefore binding at the
        # reference's own horizon (step 45); later steps are reported.
        "pass_1e-3_at_step45_f64": bool(f64_errs[45] < 1e-3),
        "pass_1e-3_at_step25_f32": bool(errs[25]["q995_rel"] < 1e-3),
    }


def config2():
    """All-pairs engine at N=16,384: throughput + parity vs dense XLA."""
    import jax
    import jax.numpy as jnp

    from ..config import SimConfig
    from ..models.engines import make_accel_fn
    from ..physics import pair_accelerations_dense

    n, g = 16384, 6.67e-11
    rng = np.random.default_rng(0)
    mj = jnp.asarray(10 ** rng.uniform(-1, np.log10(0.5), n), jnp.float32)
    pj = jnp.asarray(rng.uniform(-0.1, 0.1, (n, 2)), jnp.float32)

    accel = jax.jit(make_accel_fn(SimConfig(n_bodies=n, g=g)))
    acc = accel(pj, mj)
    with jax.default_matmul_precision("highest"):
        want = pair_accelerations_dense(pj, mj, g=g)
    rel = float(
        jnp.max(jnp.abs(acc - want)) / jnp.max(jnp.abs(want))
    )
    sec = _step_seconds(accel, pj, mj)
    return {
        "config": 2,
        "n": n,
        "pairs_per_sec": n * n / sec,
        "max_rel_err_vs_dense": rel,
        **device_label(),
    }


def config3(out_dir="."):
    """Barnes-Hut theta=0.5 at N=65,536 + dump writing."""
    import jax
    import jax.numpy as jnp

    from ..ops.bh_grouped import bh_accelerations_grouped
    from ..ops.tree import build_quadtree

    n, g = 65536, 6.67e-11
    rng = np.random.default_rng(0)
    m = (10 ** rng.uniform(-1, np.log10(0.5), n)).astype(np.float32)
    p = rng.uniform(-0.1, 0.1, (n, 2)).astype(np.float32)
    mj, pj = jnp.asarray(m), jnp.asarray(p)

    build_sec = _step_seconds(
        jax.jit(lambda p: build_quadtree(p, mj, max_depth=9)), pj
    )
    acc, ovf = bh_accelerations_grouped(
        pj, mj, g=g, theta=0.5, return_diagnostics=True,
    )
    force_sec = _step_seconds(
        jax.jit(lambda p: bh_accelerations_grouped(p, mj, g=g, theta=0.5)),
        pj,
    )

    # dumps via the native reference builder (byte-identical contract)
    dump_ok = False
    try:
        from ..utils import native

        text = native.tree_dump(p.astype(np.float64), m.astype(np.float64))
        with open(os.path.join(out_dir, "quadtree_init_baseline.txt"), "w") as f:
            f.write(text)
        dump_ok = True
    except Exception:
        pass
    return {
        "config": 3,
        "n": n,
        "tree_build_seconds": build_sec,
        "step_seconds_incl_build": force_sec,
        "steps_per_sec": 1.0 / force_sec,
        "overflowed_bodies": int(np.asarray(ovf).sum()),
        "dump_written": dump_ok,
        "ref_best_step_seconds_40k": 0.0065,  # project_report.pdf p.24
        **device_label(),
    }


FAKE_MESH_NOTE = (
    "fake 8-device CPU mesh: all 8 devices share ONE physical host core, "
    "so flat wall-clock (efficiency ~1/devices) is the EXPECTED CORRECT "
    "outcome here — this record validates sharding correctness and the "
    "5-repeat protocol, not hardware speedup.  See "
    "'projection_real_hardware' for the modeled multi-card curve "
    "(compute-per-card + comm-volume / NVLink bandwidth)."
)


def config45(weak: bool, fake_mesh: str = "never"):
    """Strong (fixed N=262,144) / weak (131,072 per device) scaling.

    NBODY_BASELINE_SCALE divides the body counts (the fake mesh runs the
    protocol at reduced size).  Runs at the visible device counts; fewer
    than two devices is an error unless ``fake_mesh="always"`` asks for the
    labeled fake 8-device CPU mesh (a subprocess that never touches the
    card), in which case a GPU parent adds one devices=1 anchor at the
    config's real N."""
    import jax

    from ..device import kernel_route

    if fake_mesh == "always":
        rec = _config45_fake_mesh(weak)
        rec["note"] = FAKE_MESH_NOTE
        if kernel_route() == "gpu":
            rec["anchor_devices1_real_chip"] = _config4_anchor(
                n=131072 if weak else 262144
            )
        _annotate_comm_and_projection(rec, weak)
        return rec
    if jax.device_count() < 2:
        raise RuntimeError(
            f"config {5 if weak else 4} needs >= 2 devices (found "
            f"{jax.device_count()}); pass --fake-mesh always for the "
            "labeled fake-mesh protocol check"
        )

    from ..config import MeshConfig, SimConfig
    from ..parallel import make_mesh, make_sharded_step, shard_state
    from ..rng import random_state

    scale = int(os.environ.get("NBODY_BASELINE_SCALE", "1"))
    n_dev_max = jax.device_count()
    on_gpu = kernel_route() == "gpu"
    results = []
    counts = [d for d in (1, 2, 4, 8) if d <= n_dev_max]
    for n_dev in counts:
        n = (131072 * n_dev if weak else 262144) // scale
        # the CPU fake mesh keeps the evaluated [chunk, gs, K] lists small
        cfg = SimConfig(
            n_bodies=n,
            engine="barnes_hut",
            mesh=MeshConfig(dp=n_dev),
            group_chunk=4,
            group_size=2048 if on_gpu else 512,
            frontier_cap=None if on_gpu else 1024,
            list_cap=None if on_gpu else 768,
            direct_cap=None if on_gpu else 1024,
            direct_body_cap=None if on_gpu else 8192,
        )
        state = random_state(cfg)
        mesh = make_mesh(n_dev)
        state = shard_state(state, mesh)
        step = make_sharded_step(cfg, mesh, "dp_barnes_hut_grouped")
        state = jax.block_until_ready(step(state))
        t0 = time.perf_counter()
        for _ in range(3):
            state = step(state)
        jax.block_until_ready(state)
        sec = (time.perf_counter() - t0) / 3
        results.append({"devices": n_dev, "n": n, "step_seconds": sec})
    base = results[0]["step_seconds"]
    for r in results:
        r["speedup"] = base / r["step_seconds"] if not weak else None
        r["efficiency"] = (
            base / r["step_seconds"] / r["devices"] if not weak else
            base / r["step_seconds"]
        )
    rec = {
        "config": 5 if weak else 4,
        **device_label(),
        "scale_divisor": scale,
        "points": results,
    }
    _annotate_comm_and_projection(rec, weak)
    return rec


def _annotate_comm_and_projection(rec, weak: bool) -> None:
    """Attach the analytic comm volume to every scaling point and a
    modeled real-hardware speedup/efficiency curve.

    The comm numbers come from parallel/memory.comm_bytes_per_step (the
    inventory is asserted against the traced jaxpr's collective operand
    shapes — tests/test_comm_model.py); the projection combines them
    with the real-card devices=1 anchor:

        T(d) = compute(1 card's share) + comm_bytes(d) / link_bandwidth

    where compute = anchor/d (strong, fixed N) or anchor (weak, fixed
    N/card), and the link bandwidth is the anchor card's published
    NVLink rate per direction (bench/hardware.py) — the reference's
    analogue is its measured per-step PCIe staging cost (project.cu:968,
    1010; project_report.pdf p.22)."""
    from ..config import SimConfig
    from ..parallel.memory import comm_bytes_per_step
    from .hardware import device_spec

    mode = "dp_barnes_hut_grouped"
    for pt in rec.get("points", []):
        cfg = SimConfig(n_bodies=pt["n"])
        pt["comm_bytes_per_step_per_chip"] = comm_bytes_per_step(
            cfg, pt["devices"], mode
        )

    anchor = rec.get("anchor_devices1_real_chip") or {}
    t1 = anchor.get("step_seconds")
    if not t1:
        return
    n1 = anchor["n"]
    link = device_spec(anchor["device_kind"])["nvlink_bytes_per_s"]
    # Amdahl term: grouped mode rebuilds the WHOLE tree on every chip,
    # so the build cost does not scale with devices.  Measured (or
    # anchor-recorded) tree build at the anchor N; evaluation is the
    # rest and scales 1/d (strong) / stays per-chip-constant (weak).
    tree_sec = anchor.get("tree_build_seconds") or 0.0
    ev1 = max(t1 - tree_sec, 0.0)
    proj = []
    for d in (1, 2, 4, 8):
        n = n1 * d if weak else n1
        comm = comm_bytes_per_step(SimConfig(n_bodies=n), d, mode)
        compute = (tree_sec + ev1) if weak else (tree_sec + ev1 / d)
        t = compute + comm / link
        speedup = None if weak else t1 / t
        eff = (t1 / t) if weak else (t1 / t / d)
        proj.append(
            {
                "devices": d,
                "n": n,
                "modeled_step_seconds": t,
                "modeled_comm_seconds": comm / link,
                "speedup": speedup,
                "efficiency": eff,
            }
        )
    rec["projection_real_hardware"] = {
        "inputs": {
            "anchor_step_seconds_devices1": t1,
            "anchor_n": n1,
            "anchor_tree_build_seconds": tree_sec,
            "mode": mode,
            "link_bytes_per_sec": link,
            "comm_model": "parallel/memory.comm_bytes_per_step "
            "(jaxpr-verified inventory, ring-algorithm wire costs)",
            "amdahl_note": "tree build is redundant per chip in grouped "
            "mode and does not scale with devices; weak-scaling compute "
            "per chip is approximated as constant (each chip's targets "
            "are fixed; tree term grows with log N)",
        },
        "points": proj,
    }


def _config4_anchor(n=262144):
    """devices=1 point of config 4/5 at the REAL scaling N on the card
    (grouped BH)."""
    import jax
    import jax.numpy as jnp

    from ..ops.bh_grouped import bh_accelerations_grouped
    from ..ops.tree import build_quadtree

    g = 6.67e-11
    rng = np.random.default_rng(0)
    m = jnp.asarray(
        10 ** rng.uniform(-1, np.log10(0.5), n), jnp.float32
    )
    p = jnp.asarray(rng.uniform(-0.1, 0.1, (n, 2)), jnp.float32)
    sec = _step_seconds(
        jax.jit(lambda p: bh_accelerations_grouped(p, m, g=g, theta=0.5)),
        p,
    )
    # the redundant-per-card Amdahl term for the scaling projection
    build_sec = _step_seconds(jax.jit(lambda p: build_quadtree(p, m)), p)
    _, ovf = bh_accelerations_grouped(
        p, m, g=g, theta=0.5, return_diagnostics=True
    )
    return {
        "devices": 1,
        "n": n,
        "step_seconds": sec,
        "tree_build_seconds": build_sec,
        "overflowed_bodies": int(np.asarray(ovf).sum()),
        **device_label(),
    }


def _config45_fake_mesh(weak: bool):
    """Re-exec config45 on a fake 8-device CPU mesh in a subprocess."""
    import subprocess

    env = dict(os.environ)
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    # keep the fake-mesh run tractable: all 8 "devices" share one host
    env.setdefault("NBODY_BASELINE_SCALE", "32")
    # the child must resolve nbody independent of the parent's cwd
    # (same fix as sweeps._bootstrap_fake_mesh)
    pkg_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    env["PYTHONPATH"] = os.pathsep.join(
        [pkg_root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    env["JAX_PLATFORMS"] = "cpu"  # the child never touches the card
    code = (
        "import json\n"
        "from nbody.bench import baseline\n"
        f"r = baseline.config45(weak={weak})\n"
        "print('RESULT:' + json.dumps(r))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env,
        capture_output=True, text=True,
    )
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT:"):
            rec = json.loads(line[len("RESULT:"):])
            rec["backend"] = "cpu-fake-8-device-mesh"
            return rec
    raise RuntimeError(
        f"fake-mesh config45 subprocess failed (rc={proc.returncode}): "
        f"{proc.stderr[-500:]}"
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--out", default="baseline_results.json")
    ap.add_argument(
        "--fake-mesh", choices=["never", "always"], default="never",
        help="configs 4-5: always = run the labeled fake 8-device CPU "
        "mesh protocol instead of the visible devices",
    )
    args = ap.parse_args(argv)
    wanted = {int(c) for c in args.configs.split(",")}
    report = []
    for c in sorted(wanted):
        print(f"running config {c}...", file=sys.stderr)
        try:
            if c == 1:
                report.append(config1())
            elif c == 2:
                report.append(config2())
            elif c == 3:
                report.append(config3())
            elif c == 4:
                report.append(config45(False, args.fake_mesh))
            elif c == 5:
                report.append(config45(True, args.fake_mesh))
        except Exception as e:  # record the failure, keep going
            report.append({"config": c, "error": str(e)[:500]})
        print(json.dumps(report[-1]), file=sys.stderr)
    # merge into an existing results file: a partial re-run (e.g.
    # --configs 2,3) must not clobber the configs it did not run.
    # Atomic write: tmp file + os.replace.
    if os.path.exists(args.out):
        try:
            with open(args.out) as f:
                prior = json.load(f)
            report = [
                r for r in prior if r.get("config") not in wanted
            ] + report
            report.sort(key=lambda r: r.get("config", 99))
        except Exception:
            pass  # unreadable prior file: write the fresh records
    tmp = args.out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=2)
    os.replace(tmp, args.out)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
