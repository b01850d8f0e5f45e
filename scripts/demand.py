"""Per-level traversal-demand calibration (sizes the frontier/list caps).

Runs the grouped collector with ``fmul``x the engine's own frontier
schedule (default 2x; 4x-peak-everywhere runs out of device memory at
512K+ — the per-level compaction sorts are [G, 8*cap] wide) and return_demand=True,
printing max-over-groups opened-children demand per level plus
approx/direct per-group maxima — the numbers behind frontier_schedule /
cap_defaults in ops/bh_grouped.py and ops/bh3d.py.  Demand is counted
BEFORE truncation, so any level whose demand exceeds its (multiplied)
cap is visible; if one does, re-run with a larger fmul — deeper levels
were under-walked.  list/direct caps don't affect the counts (masks are
summed pre-compaction), so they stay small here.

Usage: python scripts/demand.py n=524288,dims=3,init=uniform [spec...]
Optional keys: gs, theta, dcm (override direct_cell_max), fmul, steps
(advance the state N steps with the real engine first — demand shifts
as the cloud collapses).
"""

import sys

import jax.numpy as jnp
import numpy as np

G = 6.67e-11


def run(n, dims, init="uniform", gs=2048, theta=0.5, dcm=None, fmul=2,
        steps=0):
    rng = np.random.default_rng(0)
    masses = jnp.asarray(
        10 ** rng.uniform(-1, np.log10(0.5), n), jnp.float32
    )
    if init == "blobs":
        k = n // 2
        c = rng.uniform(-0.05, 0.05, (2, dims))
        pts = np.concatenate([
            rng.normal(c[0], 0.004, (k, dims)),
            rng.normal(c[1], 0.004, (n - k, dims)),
        ])
        pos = jnp.asarray(np.clip(pts, -0.1, 0.1), jnp.float32)
    else:
        pos = jnp.asarray(rng.uniform(-0.1, 0.1, (n, dims)), jnp.float32)

    if dims == 3:
        from nbody.ops.bh3d import (
            _collect_lists_3d as collect,
            bh3_accelerations_grouped as engine,
            direct_cell_max_default,
            frontier_peak_3d,
            frontier_schedule_3d,
        )
        from nbody.ops.tree3d import build_octree as build
        from nbody.ops.tree3d import default_max_depth3

        md = default_max_depth3(n)
        dcm = dcm or direct_cell_max_default(n)
        kids = 8
        sched = frontier_schedule_3d(frontier_peak_3d(n), md, n)
    else:
        from nbody.ops.bh_grouped import (
            _collect_lists as collect,
            bh_accelerations_grouped as engine,
            frontier_peak,
            frontier_schedule,
        )
        from nbody.ops.tree import build_quadtree as build

        md = 9
        dcm = dcm or 32
        kids = 4
        sched = frontier_schedule(frontier_peak(n), md, n)

    for _ in range(steps):
        pos = pos + engine(pos, masses, g=G, theta=theta)

    generous = tuple(
        min(kids**lv, fmul * c) for lv, c in enumerate(sched)
    )
    tree = build(pos, masses, max_depth=md)
    src_order = jnp.argsort(tree.codes)
    tsort = pos[src_order]
    n_sub = max(4, gs // 128)
    pg = tsort.reshape(-1, gs, dims)
    sub = pg.reshape(pg.shape[0], n_sub, gs // n_sub, dims)
    bbox = tuple(
        b
        for d_ in range(dims)
        for b in (jnp.min(sub[..., d_], axis=2), jnp.max(sub[..., d_], axis=2))
    )
    out = collect(
        bbox, tree, theta=theta, softening=1e-15,
        frontier_caps=generous, list_cap=4096,
        direct_cap=4096, direct_cell_max=dcm, return_demand=True,
    )
    stats = out[3]
    fr = np.asarray(stats["frontier"])
    truncated = [
        lv + 1
        for lv, d in enumerate(fr.tolist())
        if d > generous[lv + 1]
    ]
    print(
        f"N={n} dims={dims} init={init} gs={gs} theta={theta} dcm={dcm} "
        f"steps={steps} fmul={fmul}\n"
        f"  engine schedule:                    {list(sched)}\n"
        f"  frontier demand entering levels 1..{md}: {fr.tolist()}\n"
        f"  approx max/group: {int(stats['approx'])}   "
        f"direct max/group: {int(stats['direct'])}"
        + (
            f"\n  WARNING: demand TRUNCATED at levels {truncated} — "
            "re-run with a larger fmul"
            if truncated
            else ""
        ),
        flush=True,
    )


if __name__ == "__main__":
    for spec in sys.argv[1:]:
        parts = dict(kv.split("=") for kv in spec.split(","))
        run(
            int(parts.get("n", 65536)),
            int(parts.get("dims", 2)),
            init=parts.get("init", "uniform"),
            gs=int(parts.get("gs", 2048)),
            theta=float(parts.get("theta", 0.5)),
            dcm=int(parts["dcm"]) if "dcm" in parts else None,
            fmul=int(parts.get("fmul", 2)),
            steps=int(parts.get("steps", 0)),
        )
