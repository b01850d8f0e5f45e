"""Phase split of the grouped BH engines (2D and 3D).

Times nested prefixes of the pipeline (tree | +collect | +expand |
full); differences give per-phase costs.  Each time is the median of
``reps`` calls ended by ``block_until_ready`` after a compiling call.

Usage: python scripts/phase_split.py n=262144,dims=3 [spec...]
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np

G = 6.67e-11


def split(n, dims, gs=2048, reps=5, collect=None, **kw):
    rng = np.random.default_rng(0)
    masses = jnp.asarray(
        10 ** rng.uniform(-1, np.log10(0.5), n), jnp.float32
    )

    def cloud():
        return jnp.asarray(rng.uniform(-0.1, 0.1, (n, dims)), jnp.float32)

    if dims == 3:
        from nbody.ops.bh3d import (
            _collect_lists_3d,
            bh3_accelerations_grouped,
            cap_defaults_3d,
            direct_cell_max_default,
            frontier_schedule_3d,
        )
        from nbody.ops.bh_grouped import _expand_ranges_superblocks
        from nbody.ops.tree3d import build_octree, default_max_depth3

        md = default_max_depth3(n)
        caps = cap_defaults_3d(n)
        dcm = direct_cell_max_default(n)
        fcaps = frontier_schedule_3d(caps["frontier_cap"], md, n)
        n_sub = max(4, gs // 128)

        def prefix(p, depth):
            tree = build_octree(p, masses, max_depth=md)
            src_order = jnp.argsort(tree.codes)
            packed = jnp.concatenate([p, masses[:, None]], axis=1)
            psort = packed[src_order]
            if depth == 0:
                return tree.raw[0][0, 0] + psort[0, 0]
            tsort = psort[:, 0:dims]
            pg = tsort.reshape(-1, gs, dims)
            sub = pg.reshape(pg.shape[0], n_sub, gs // n_sub, dims)
            bbox = sum(
                [
                    [jnp.min(sub[..., d_], axis=2),
                     jnp.max(sub[..., d_], axis=2)]
                    for d_ in range(dims)
                ],
                [],
            )
            if collect == "dense":
                from nbody.ops.collect_dense3 import (
                    build_spatial_pyramid,
                    collect_lists_3d_dense,
                )

                spyr = build_spatial_pyramid(
                    p, masses, tree.bounds, md
                )
                lists, ranges, ovf = collect_lists_3d_dense(
                    tuple(bbox), tree, spyr, theta=0.5,
                    softening=1e-15, frontier_caps=fcaps,
                    list_cap=caps["list_cap"],
                    direct_cap=caps["direct_cap"], direct_cell_max=dcm,
                )
            else:
                lists, ranges, ovf = _collect_lists_3d(
                    tuple(bbox), tree, theta=0.5, softening=1e-15,
                    frontier_caps=fcaps, list_cap=caps["list_cap"],
                    direct_cap=caps["direct_cap"], direct_cell_max=dcm,
                )
            if depth == 1:
                return lists[0][0, 0] + ranges[0, 0, 0].astype(jnp.float32)
            sb_cap = caps["direct_body_cap"] // 8 + caps["direct_cap"]
            sb_idx, lo, hi, ovf2 = _expand_ranges_superblocks(
                ranges, dcm, sb_cap
            )
            if depth == 2:
                return (
                    lists[0][0, 0] + sb_idx.astype(jnp.float32)[0, 0]
                )
            raise ValueError

        full = functools.partial(
            bh3_accelerations_grouped, g=G, theta=0.5, collect=collect,
            **kw
        )
    else:
        from nbody.ops.bh_grouped import (
            _collect_lists,
            _expand_ranges_superblocks,
            bh_accelerations_grouped,
            cap_defaults,
            frontier_schedule,
        )
        from nbody.ops.tree import build_quadtree

        md = 9
        caps = cap_defaults(gs, n)
        fcaps = frontier_schedule(caps["frontier_cap"], md, n)
        n_sub = max(4, gs // 128)

        def prefix(p, depth):
            tree = build_quadtree(p, masses, max_depth=md)
            src_order = jnp.argsort(tree.codes)
            packed = jnp.concatenate([p, masses[:, None]], axis=1)
            psort = packed[src_order]
            if depth == 0:
                return tree.raw[0][0, 0] + psort[0, 0]
            tsort = psort[:, 0:2]
            pg = tsort.reshape(-1, gs, 2)
            sub = pg.reshape(pg.shape[0], n_sub, gs // n_sub, 2)
            bbox = (
                jnp.min(sub[..., 0], axis=2), jnp.max(sub[..., 0], axis=2),
                jnp.min(sub[..., 1], axis=2), jnp.max(sub[..., 1], axis=2),
            )
            lists, ranges, ovf = _collect_lists(
                bbox, tree, theta=0.5, softening=1e-15,
                frontier_caps=fcaps, list_cap=caps["list_cap"],
                direct_cap=caps["direct_cap"], direct_cell_max=32,
            )
            if depth == 1:
                return lists[0][0, 0] + ranges[0, 0, 0].astype(jnp.float32)
            sb_cap = caps["direct_body_cap"] // 8 + caps["direct_cap"]
            sb_idx, lo, hi, ovf2 = _expand_ranges_superblocks(
                ranges, 32, sb_cap
            )
            if depth == 2:
                return lists[0][0, 0] + sb_idx.astype(jnp.float32)[0, 0]
            raise ValueError

        full = functools.partial(
            bh_accelerations_grouped, g=G, theta=0.5, **kw
        )

    def timed(fn):
        from nbody.bench.headline import time_call

        return time_call(jax.jit(fn), cloud(), reps=reps)[1]

    t_tree = timed(lambda p: jnp.broadcast_to(prefix(p, 0) * 1e-30, p.shape))
    t_coll = timed(lambda p: jnp.broadcast_to(prefix(p, 1) * 1e-30, p.shape))
    t_exp = timed(lambda p: jnp.broadcast_to(prefix(p, 2) * 1e-30, p.shape))
    t_full = timed(lambda p: full(p, masses))
    print(
        f"N={n} dims={dims} gs={gs} {kw}: tree+sort {t_tree*1e3:.1f} | "
        f"collect {(t_coll-t_tree)*1e3:.1f} | "
        f"expand {(t_exp-t_coll)*1e3:.1f} | "
        f"eval(+rest) {(t_full-t_exp)*1e3:.1f} | "
        f"full {t_full*1e3:.1f} ms/step",
        flush=True,
    )


if __name__ == "__main__":
    print("devices:", jax.devices(), file=sys.stderr)
    for spec in sys.argv[1:]:
        parts = dict(kv.split("=") for kv in spec.split(","))
        n = int(parts.pop("n", 65536))
        dims = int(parts.pop("dims", 2))
        gs = int(parts.pop("gs", 2048))
        reps = int(parts.pop("reps", 5))
        coll = parts.pop("collect", None)
        kw = {k: int(v) for k, v in parts.items()}
        split(n, dims, gs=gs, reps=reps, collect=coll, **kw)
