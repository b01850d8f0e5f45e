"""Smoke test of the main paths on an NVIDIA GPU, at the sizes users run.

    python chip_smoke.py               # one card: phases 1-5
    python chip_smoke.py --multi-card  # four cards: every sharded mode

One card:

1. Device check.  JAX's first device must be a GPU (JAX falls back to the
   CPU when the CUDA plugin fails to start); prints the device kind and
   count and ``nvidia-smi``'s name and power limit.
2. 2D all-pairs, N=65,536: 10 steps through ``nbody.cli.main``; the tiled
   kernel against an f64 all-pairs reference computed on the card; the
   kernel against the plain XLA pair sum (median of 5 timed calls each).
3. 3D all-pairs, N=65,536: the same kernel comparison.
4. 2D grouped Barnes-Hut, N=65,536, theta=0.5: 10 steps through
   ``Simulation.run_contract``; step-0 forces against f64 all-pairs.
5. 3D grouped Barnes-Hut, N=1,048,576 (the dense collector): 3 steps;
   4,096 sampled targets against f64 all-pairs over all sources.

``--multi-card`` runs only the sharded modes of ``make_sharded_step`` on
four cards (2D modes at N=262,144, 3D at N=1,048,576, and ``auto``), each
against the single-card step of the same state.

Each phase prints one line: set-up (compile) seconds, ms/step, its error
beside the bound, the overflow count, the compiled program's memory
analysis and the card's peak bytes in use.  A failed check raises, so the
script exits non-zero without a result line.  The last stdout line is the
JSON result.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import re
import subprocess
import time

import numpy as np

from nbody.bench.headline import time_call
from nbody.config import BH_SOFTENING, G_DEFAULT as G

SEED = 0
REPS = 5

ALLPAIRS_BOUND = 1e-4  # max |a - a64| / max |a64|   (tests/test_3d.py)
BH2_BOUND = 1e-3  # max |a - a64| / max |a64|        (tests/test_bh_grouped.py)
# Per-body relative error of 3D grouped Barnes-Hut at theta=0.5, 1M bodies.
# The monopole error grows with N at fixed theta: 6.6e-4 / 4.0e-3 (median /
# q99) at 64K, 2.2e-3 / 5.3e-3 at 1M on the card (PERF.md), so the 1e-4
# median of tests/test_3d.py (a 2,048-body cloud) cannot hold here.  These
# bounds admit that accuracy; a dropped list, a misplaced source block or
# a lost direct section gives errors of order 1.
BH3_MEDIAN_BOUND = 5e-3
BH3_Q99_BOUND = 2e-2

# (mode, dims, single-card reference engine, position tolerance x scale,
# force tolerance).  Positions use the tolerances of tests/test_parallel.py
# and tests/test_3d.py.  At the non-chaotic MULTI_CARD_DT the forces move
# bodies by ~1e-4 of the position scale in two steps, so the position
# check alone would pass a mode that lost half its sources; the force the
# steps applied (v - v0) is checked body by body as well: the q99 of each
# body's difference over the RMS force.  All-pairs modes differ only in
# summation order, Barnes-Hut modes also by their own approximation
# (sharded target groups have other bounding boxes; the window modes
# aggregate close cells at Morton seams, as the reference's DFS does at
# max depth, so a few bodies differ by much more).  A lost shard or list
# moves the q99 to order 1.
MULTI_CARD_MODES = (
    ("dp_allpairs", 2, "allpairs", 5e-6, 1e-4),
    ("ring_allpairs", 2, "allpairs", 5e-6, 1e-4),
    ("dp2d_allpairs", 2, "allpairs", 5e-6, 1e-4),
    ("dp_barnes_hut", 2, "exact", 5e-6, 2e-2),
    ("dp_barnes_hut_grouped", 2, "grouped", 5e-5, 2e-2),
    ("dp_barnes_hut_sharded", 2, "grouped", 5e-5, 2e-2),
    ("auto", 2, "grouped", 5e-5, 2e-2),
    ("dp_barnes_hut_grouped3", 3, "grouped", 1e-5, 2e-2),
    ("dp_barnes_hut_sharded3", 3, "grouped", 1e-4, 2e-2),
    ("auto", 3, "grouped", 1e-5, 2e-2),
)


def log(*a):
    print(*a, flush=True)


def device_check(n_cards: int):
    """The visible GPUs (at least ``n_cards``), after printing what they
    are."""
    from nbody.device import require_gpu

    devices = require_gpu()
    if len(devices) < n_cards:
        raise SystemExit(
            f"needs {n_cards} GPUs, found {len(devices)}"
        )
    log(
        f"device: {devices[0].device_kind}, count {len(devices)}, "
        f"platform {devices[0].platform}"
    )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    for line in smi.stdout.strip().splitlines():
        log(f"nvidia-smi: {line.strip()}")
    return devices


def memory_summary(compiled) -> dict | None:
    ma = compiled.memory_analysis()
    if ma is None:
        return None
    return {
        k: int(getattr(ma, k))
        for k in dir(ma)
        if k.endswith("_size_in_bytes")
    }


def peak_bytes(device=None):
    import jax

    stats = (device or jax.devices()[0]).memory_stats()
    return stats.get("peak_bytes_in_use") if stats else None


def compile_timed(fn, *args):
    """``(compiled, seconds)`` of ahead-of-time compiling jit(fn)."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def f64_accelerations(targets, sources, masses, softening=0.0):
    """All-pairs accelerations of ``targets`` in float64, on the device."""
    import jax
    import jax.numpy as jnp

    from nbody.physics import pair_accelerations_chunked

    with jax.enable_x64(True):
        fn = jax.jit(
            functools.partial(
                pair_accelerations_chunked, g=G, softening=softening
            )
        )
        out = fn(
            jnp.asarray(sources).astype(jnp.float64),
            jnp.asarray(masses).astype(jnp.float64),
            targets=jnp.asarray(targets).astype(jnp.float64),
        )
        return np.asarray(out)


def _state(n, dims):
    from nbody.config import SimConfig
    from nbody.rng import random_state

    return random_state(SimConfig(n_bodies=n, n_dim=dims, seed=SEED))


def _report(name, **fields):
    log(f"phase {name}: " + ", ".join(f"{k} {v}" for k, v in fields.items()))


def phase_cli_allpairs(n: int = 65536, steps: int = 10) -> dict:
    """``nbody run --engine allpairs`` in-process; ms/step from its
    timing contract line."""
    from nbody.cli import main

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main([
            "run", "--engine", "allpairs", "--n-bodies", str(n),
            "--steps", str(steps), "--seed", str(SEED),
        ])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli run exited {rc}: {out.getvalue()}")
    text = out.getvalue()
    total_ms = float(re.search(r"took\s+(\d+)\s+milliseconds", text)[1])
    par_us = float(re.search(r"took\s+(\d+)\s+microseconds", text)[1])
    rec = dict(
        setup_s=round(wall - total_ms / 1e3, 3),
        ms_per_step=par_us / steps / 1e3,
        overflow=0,
        peak_bytes=peak_bytes(),
    )
    _report(f"cli-allpairs-2d n={n} steps={steps}", **rec)
    return rec


def phase_allpairs(
    n: int = 65536, dims: int = 2, reps: int = REPS, interpret: bool = False
) -> dict:
    """The tiled kernel vs an f64 reference and vs the plain XLA pair sum
    (float32, HIGHEST matmul precision)."""
    import jax

    from nbody.ops.allpairs import allpairs_accelerations
    from nbody.physics import pair_accelerations_chunked

    state = _state(n, dims)
    pos, m = state.positions, state.masses
    kernel, setup = compile_timed(
        functools.partial(allpairs_accelerations, g=G, interpret=interpret),
        pos, m,
    )
    _, t_kernel, acc = time_call(kernel, pos, m, reps=reps)
    with jax.default_matmul_precision("highest"):
        xla, setup_xla = compile_timed(
            functools.partial(pair_accelerations_chunked, g=G), pos, m
        )
        _, t_xla, acc_xla = time_call(xla, pos, m, reps=reps)
    ref = f64_accelerations(pos, pos, m)
    scale = np.abs(ref).max()
    err = float(np.abs(np.asarray(acc) - ref).max() / scale)
    err_xla = float(np.abs(np.asarray(acc_xla) - ref).max() / scale)
    rec = dict(
        setup_s=round(setup, 3),
        ms_per_step=t_kernel * 1e3,
        xla_setup_s=round(setup_xla, 3),
        xla_ms_per_step=t_xla * 1e3,
        speedup_vs_xla=t_xla / t_kernel,
        gpairs_per_s=n * n / t_kernel / 1e9,
        err=f"{err:.3e} (bound {ALLPAIRS_BOUND:g}; xla {err_xla:.3e})",
        overflow=0,
        memory=memory_summary(kernel),
        peak_bytes=peak_bytes(),
    )
    _report(f"allpairs-{dims}d n={n}", **rec)
    if not np.isfinite(np.asarray(acc)).all() or not err < ALLPAIRS_BOUND:
        raise AssertionError(f"allpairs {dims}D error {err} out of bound")
    return rec


def phase_bh(
    n: int, dims: int, steps: int, sample: int | None = None
) -> dict:
    """Grouped Barnes-Hut through ``Simulation.run_contract`` (default
    settings: a step whose traversal caps overflow is recomputed with 4x
    caps) plus the step-0 forces against f64 all-pairs (all targets, or
    ``sample`` random targets against all sources).  Fails if any step
    still overflows after its retry."""
    from nbody.config import SimConfig
    from nbody.models.engines import make_accel_fn
    from nbody.models.simulation import Simulation

    cfg = SimConfig(
        n_bodies=n, n_dim=dims, n_steps=steps, engine="barnes_hut",
        theta=0.5, seed=SEED,
    )
    sim = Simulation(cfg)
    pos, m = sim.state.positions, sim.state.masses

    accel, setup_force = compile_timed(
        make_accel_fn(cfg, return_diagnostics=True), pos, m
    )
    _, t_force, (acc, ovf) = time_call(accel, pos, m, reps=3)
    overflow0 = int(np.asarray(ovf).sum())
    acc = np.asarray(acc)

    err_out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err_out):
        state, timing = sim.run_contract()
    wall = time.perf_counter() - t0
    final_overflow = int(state.overflow)
    stderr = err_out.getvalue()
    retried = stderr.count("retrying with 4x caps")

    if sample is None:
        idx = np.arange(n)
    else:
        idx = np.sort(
            np.random.default_rng(SEED).choice(n, sample, replace=False)
        )
    ref = f64_accelerations(
        np.asarray(pos)[idx], pos, m, softening=BH_SOFTENING
    )
    got = acc[idx]
    if dims == 2:
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        err_text = f"{err:.3e} (bound {BH2_BOUND:g})"
        ok = err < BH2_BOUND
    else:
        rel = np.linalg.norm(got - ref, axis=1) / (
            np.linalg.norm(ref, axis=1) + 1e-30
        )
        med, q99 = float(np.median(rel)), float(np.quantile(rel, 0.99))
        err_text = (
            f"median {med:.3e} (bound {BH3_MEDIAN_BOUND:g}), q99 "
            f"{q99:.3e} (bound {BH3_Q99_BOUND:g})"
        )
        ok = med < BH3_MEDIAN_BOUND and q99 < BH3_Q99_BOUND
    rec = dict(
        setup_s=round(wall - timing.total_ms / 1e3, 3),
        force_setup_s=round(setup_force, 3),
        ms_per_step=timing.parallel_us / steps / 1e3,
        force_ms=t_force * 1e3,
        err=err_text,
        overflow=(
            f"{overflow0} at step 0, {final_overflow} at the last step, "
            f"{retried} steps retried with 4x caps"
        ),
        memory=memory_summary(accel),
        peak_bytes=peak_bytes(),
    )
    _report(f"bh-grouped-{dims}d n={n} steps={steps}", **rec)
    if "WARNING: step" in stderr or overflow0 or final_overflow:
        raise AssertionError(
            f"BH {dims}D traversal caps overflowed: {stderr}"
        )
    if not np.isfinite(np.asarray(state.positions)).all():
        raise AssertionError(f"BH {dims}D positions not finite")
    if not ok:
        raise AssertionError(f"BH {dims}D error {err_text} out of bound")
    return rec


def grid_shape(n: int, dims: int) -> tuple:
    """The most nearly cubic power-of-two grid of ``n`` cells (2^20 in 3D:
    128 x 128 x 64)."""
    k = n.bit_length() - 1
    if n != 1 << k:
        raise ValueError(f"n={n} is not a power of two")
    return tuple(1 << (k // dims + (i < k % dims)) for i in range(dims))


def jittered_grid(shape, seed: int = SEED):
    """Bounded-separation cloud (one body per grid cell, jittered) in
    [-0.1, 0.1]^D, Morton-sorted so each card's slab is contiguous (the
    seeding the sharded-window modes assume; see tests/test_parallel)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    axes = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    idx = np.stack(axes, -1).reshape(-1, len(shape)).astype(np.float64)
    p = (idx + rng.uniform(0.25, 0.75, idx.shape)) / np.asarray(shape)
    p = (p * 0.2 - 0.1).astype(np.float32)
    n = p.shape[0]
    m = (10 ** rng.uniform(-1, np.log10(0.5), n)).astype(np.float32)
    v = rng.uniform(-1e-4, 1e-4, p.shape).astype(np.float32)
    if len(shape) == 2:
        from nbody.ops.tree import morton_codes, root_bounds

        codes = morton_codes(jnp.asarray(p), root_bounds(jnp.asarray(p)), 9)
    else:
        from nbody.ops.tree3d import morton_codes_3d, root_bounds_3d
        from nbody.ops.tree3d import default_max_depth3

        pj = jnp.asarray(p)
        codes = morton_codes_3d(
            pj, root_bounds_3d(pj), default_max_depth3(n)
        )
    order = np.argsort(np.asarray(codes), kind="stable")
    return m[order], p[order], v[order]


# Time step of the multi-card comparison.  At 262,144 bodies in 2D the
# grid spacing is 3.9e-4 and the largest acceleration ~1e-3, so the
# reference's dt=1 moves bodies several spacings per step: near-collisions
# then amplify f32 summation-order differences chaotically (all-pairs
# ring vs single card differed by 3e-3 of the position scale after two
# steps).  At dt=0.05 no body moves more than ~2% of a spacing per step,
# so the comparison measures the arithmetic, not the chaos.
MULTI_CARD_DT = 0.05


def _config(n, dims, engine, n_cards):
    from nbody.config import MeshConfig, SimConfig

    return SimConfig(
        n_bodies=n, n_dim=dims, dt=MULTI_CARD_DT, seed=SEED,
        engine="allpairs" if engine == "allpairs" else "barnes_hut",
        bh_mode="exact" if engine == "exact" else "grouped",
        adaptive_caps=False, mesh=MeshConfig(dp=n_cards),
    )


def single_card_state(cloud, dims, engine, steps, device):
    """(positions, velocities) after ``steps`` single-card engine steps on
    ``device``."""
    import jax

    from nbody.models.simulation import Simulation
    from nbody.state import make_state

    m, p, v = cloud
    cfg = _config(len(m), dims, engine, 1)
    with jax.default_device(device):
        sim = Simulation(cfg, state=make_state(m, p, v))
        sim.run_scan(steps)
        return np.asarray(sim.state.positions), np.asarray(
            sim.state.velocities
        )


def multi_card(
    n2: int = 262144,
    n3: int = 1 << 20,
    n_cards: int = 4,
    steps: int = 2,
    modes=MULTI_CARD_MODES,
) -> list:
    """Every sharded mode on ``n_cards`` devices against the single-card
    step of the same state.  A tree-mode step whose caps overflow is
    recomputed with 4x caps, as ``nbody run --devices`` does; the mode
    fails if any step still overflows."""
    import jax

    from nbody.models.engines import resolved_caps
    from nbody.parallel import (
        make_mesh,
        make_mesh_2d,
        make_sharded_step,
        shard_state,
    )
    from nbody.state import make_state

    devices = jax.devices()[:n_cards]
    clouds = {
        dims: jittered_grid(grid_shape(n, dims))
        for dims, n in ((2, n2), (3, n3))
        if any(md == dims for _, md, *_ in modes)
    }

    results = []
    for mode, dims, engine, tol, force_tol in modes:
        m, p, v = clouds[dims]
        cfg = _config(len(m), dims, engine, n_cards)
        if mode == "dp2d_allpairs":
            mesh = make_mesh_2d(n_cards // 2, 2)
            state = make_state(m, p, v)
        else:
            mesh = make_mesh(n_cards)
            state = shard_state(make_state(m, p, v), mesh)
        step = make_sharded_step(cfg, mesh, mode)
        fallback = None
        overflow, times, retried = [], [], 0
        for i in range(steps):
            t0 = time.perf_counter()
            new = jax.block_until_ready(step(state))
            if int(new.overflow) and engine != "allpairs":
                # the CLI's adaptive retry: recompute the step from the
                # pre-step state with every cap at 4x
                if fallback is None:
                    caps = {k: 4 * v for k, v in resolved_caps(cfg).items()}
                    fallback = make_sharded_step(
                        cfg.replace(**caps), mesh, mode
                    )
                new = jax.block_until_ready(fallback(state))
                retried += 1
            times.append(time.perf_counter() - t0)
            overflow.append(int(new.overflow))
            state = new
        setup = times.pop(0)  # the first call compiles
        spans = len(state.positions.sharding.device_set)
        results.append(dict(
            mode=mode, dims=dims, n=len(m), engine=engine, tol=tol,
            force_tol=force_tol,
            setup_s=round(setup, 3),
            ms_per_step=float(np.median(times)) * 1e3 if times else None,
            overflow=overflow, retried=retried, spans=spans,
            positions=np.asarray(state.positions),
            velocities=np.asarray(state.velocities),
        ))
        del state

    # peaks before any single-card reference runs on device 0
    peaks = [peak_bytes(d) for d in devices]

    refs = {}
    for r in results:
        key = (r["dims"], r["engine"])
        if key not in refs:
            refs[key] = single_card_state(
                clouds[r["dims"]], r["dims"], r["engine"], steps, devices[0]
            )
        want, want_v = refs[key]
        scale = np.abs(want).max()
        r["err"] = float(np.abs(r.pop("positions") - want).max() / scale)
        # the force the steps applied, v - v0, against the single card's,
        # body by body
        v0 = clouds[r["dims"]][2]
        dv = want_v - v0
        # over the RMS force: a body whose forces cancel has a tiny |dv|
        # that would inflate a per-body relative error
        rel = np.linalg.norm(r.pop("velocities") - v0 - dv, axis=1) / (
            np.sqrt(np.mean(np.sum(dv * dv, axis=1)))
        )
        r["force_err"] = float(np.quantile(rel, 0.99))
        force_text = (
            f"median {np.median(rel):.3e}, q99 {r['force_err']:.3e} "
            f"(bound {r['force_tol']:g}), max {rel.max():.3e}"
        )
        _report(
            f"multi-card {r['mode']} {r['dims']}d n={r['n']} "
            f"cards={n_cards}",
            setup_s=r["setup_s"], ms_per_step=r["ms_per_step"],
            err=f"{r['err']:.3e} (bound {r['tol']:g}, vs single-card "
            f"{r['engine']})",
            force_err=force_text,
            overflow=f"{r['overflow']} per step after "
            f"{r['retried']} retries with 4x caps",
            spans_devices=r["spans"],
        )
    log(f"multi-card peak_bytes per device (sharded modes): {peaks}")

    bad = [
        r["mode"] for r in results
        if not r["err"] <= r["tol"] or any(r["overflow"])
        or not r["force_err"] <= r["force_tol"]
        or r["spans"] != n_cards
    ]
    if bad:
        raise AssertionError(f"multi-card modes failed: {bad}")
    if all(peaks) and max(peaks) > 2 * min(peaks):
        raise AssertionError(f"per-device peak memory unbalanced: {peaks}")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--multi-card", action="store_true",
        help="run only the sharded modes on four cards",
    )
    args = ap.parse_args(argv)

    from nbody.device import enable_compile_cache

    enable_compile_cache()
    n_cards = 4 if args.multi_card else 1
    devices = device_check(n_cards)
    if args.multi_card:
        multi_card(n_cards=n_cards)
    else:
        phase_cli_allpairs(65536, steps=10)
        phase_allpairs(65536, dims=2)
        phase_allpairs(65536, dims=3)
        phase_bh(65536, dims=2, steps=10)
        phase_bh(1 << 20, dims=3, steps=3, sample=4096)
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
