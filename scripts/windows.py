"""Window-size calibration for the dense (stencil) 3D collector.

Replays the grouped dual walk (ops/bh3d._collect_lists_3d semantics,
UNCAPPED) in NumPy and records, per level, where the reached frontier
actually lives in cell coordinates relative to each group's own bbox:

  * ``extent``  — max over groups of the reach bounding box side
    (cells, per axis max) entering each level,
  * ``halo_lo/hi`` — max overhang of the reach box beyond the group's
    position bbox (cells), i.e. the stencil halo a dense window needs,
  * ``lanes`` — sum over groups of reach-cell counts (the gather rows a
    capped walk pays for at that level).

These are the numbers behind ``window_schedule_3d`` in
ops/collect_dense3.py — the dense collector reads a [W, W, W] spatial
slab per group per level instead of gathering scattered frontier rows
(the reference's per-thread pointer-chasing DFS, project.cu:631-726,
has no analogue of either; this is the data-parallel redesign of its
traversal).

Usage: python scripts/windows.py n=262144,init=uniform [spec...]
Keys: n, init(uniform|blobs), gs, theta, dcm, steps.
"""

import sys

import numpy as np

G_CONST = 6.67e-11
MASS_SKIP = 1e-15


def _state(n, init, steps, theta, dims=3):
    import jax

    jax.config.update("jax_platforms", "cpu")
    rng = np.random.default_rng(0)
    masses = 10 ** rng.uniform(-1, np.log10(0.5), n)
    if init == "blobs":
        k = n // 2
        c = rng.uniform(-0.05, 0.05, (2, dims))
        pts = np.concatenate([
            rng.normal(c[0], 0.004, (k, dims)),
            rng.normal(c[1], 0.004, (n - k, dims)),
        ])
        pos = np.clip(pts, -0.1, 0.1)
    else:
        pos = rng.uniform(-0.1, 0.1, (n, dims))
    if steps:
        import jax.numpy as jnp

        assert dims == 3, "steps>0 supported for dims=3 only"
        from nbody.ops.bh3d import bh3_accelerations_grouped

        p = jnp.asarray(pos, jnp.float32)
        m = jnp.asarray(masses, jnp.float32)
        for _ in range(steps):
            p = p + bh3_accelerations_grouped(p, m, g=G_CONST, theta=theta)
        pos = np.asarray(p, np.float64)
    return masses.astype(np.float32), pos.astype(np.float32)


def run(n, init="uniform", gs=2048, theta=0.5, dcm=None, steps=0,
        dims=3):
    if dims == 3:
        from nbody.ops.bh3d import direct_cell_max_default
        from nbody.ops.tree3d import (
            build_octree as build,
            default_max_depth3,
        )

        md_default = default_max_depth3(n)
        dcm = dcm or direct_cell_max_default(n)
    else:
        from nbody.ops.tree import build_quadtree as build

        md_default = 9
        dcm = dcm or 32

    masses, pos = _state(n, init, steps, theta, dims)
    md = md_default
    tree = build(pos, masses, max_depth=md)
    bounds = np.asarray(tree.bounds, np.float64)
    raw = [np.asarray(r, np.float32) for r in tree.raw]
    order = np.argsort(np.asarray(tree.codes), kind="stable")
    ps = pos[order]
    g = (n + gs - 1) // gs
    q = max(4, gs // 128)
    sub = ps[: g * gs].reshape(g, q, gs // q, dims)
    blo = sub.min(axis=2)  # [G, Q, dims]
    bhi = sub.max(axis=2)
    glo, ghi = blo.min(axis=1), bhi.max(axis=1)  # [G, dims] group bbox

    lo = bounds[0::2]
    hi = bounds[1::2]
    size_l = [(hi - lo).max() / (1 << lv) for lv in range(md + 1)]
    cell = [(hi - lo) / (1 << lv) for lv in range(md + 1)]

    def coords(idx, lv):
        """De-interleave Morton cell index -> per-axis coords at level
        lv (x = bit 0 of each dims-bit group; tree/tree3d packing)."""
        cs = [np.zeros_like(idx) for _ in range(dims)]
        for k in range(lv):
            for a in range(dims):
                cs[a] |= ((idx >> (dims * k + a)) & 1) << k
        return np.stack(cs, axis=-1)

    print(f"# n={n} init={init} md={md} dcm={dcm} G={g} Q={q} steps={steps}")
    print("# lvl | reach-extent(cells) | halo_lo | halo_hi | "
          "bbox-extent | lanes(sum) | lanes(max/grp)")
    frontier = [np.zeros(1, np.int64) for _ in range(g)]
    per_group_ext = [[] for _ in range(md + 1)]
    for lv in range(md + 1):
        last = lv == md
        lanes = np.array([len(f) for f in frontier])
        ext = np.zeros(dims, np.int64)
        hlo = np.full(dims, -(10**9), np.int64)
        hhi = np.full(dims, -(10**9), np.int64)
        nxt = []
        r = raw[lv]
        for gi in range(g):
            idx = frontier[gi]
            if len(idx) == 0:
                nxt.append(idx)
                continue
            rows = r[idx]
            m = rows[:, 0]
            cnt = rows[:, 2 * dims + 1]
            safe = np.where(m > 0, m, 1.0)
            com = np.where(
                (cnt == 1.0)[:, None],
                rows[:, dims + 1 : 2 * dims + 1],
                rows[:, 1 : dims + 1] / safe[:, None],
            )
            d = np.maximum(
                np.maximum(
                    blo[gi][:, None, :] - com[None, :, :],
                    com[None, :, :] - bhi[gi][:, None, :],
                ),
                0.0,
            )  # [Q, F, 3]
            dmin = np.sqrt((d * d).sum(-1).min(axis=0)) + 1e-15
            ok = size_l[lv] < theta * dmin
            nonempty = (cnt > 0) & (m > MASS_SKIP)
            multi = nonempty & (cnt > 1)
            direct = multi & ~ok & (not last) & (cnt <= dcm)
            open_ = multi & ~ok & ~direct & (not last)

            c = coords(idx, lv)
            occ = c[nonempty | (cnt > 0)]
            if len(occ):
                span = occ.max(0) - occ.min(0) + 1
                ext = np.maximum(ext, span)
                per_group_ext[lv].append(int(span.max()))
                gl = np.floor((glo[gi] - lo) / cell[lv]).astype(np.int64)
                gh = np.floor((ghi[gi] - lo) / cell[lv]).astype(np.int64)
                hlo = np.maximum(hlo, gl - occ.min(0))
                hhi = np.maximum(hhi, occ.max(0) - gh)
            if last or not open_.any():
                nxt.append(np.zeros(0, np.int64))
                continue
            par = idx[open_]
            nk = 2**dims
            kids = (par[:, None] * nk + np.arange(nk)).ravel()
            kcnt = raw[lv + 1][kids, 2 * dims + 1]
            nxt.append(kids[kcnt > 0])
        frontier = nxt
        print(
            f"{lv:3d} | {ext.max():5d} | {max(hlo.max(), 0):4d} | "
            f"{max(hhi.max(), 0):4d} | "
            f"{int(np.ceil(((ghi - glo) / cell[lv]).max())):5d} | "
            f"{lanes.sum():9d} | {lanes.max():7d}"
        )
        e = np.sort(per_group_ext[lv]) if per_group_ext[lv] else np.zeros(1)
        pct = [int(np.percentile(e, p)) for p in (50, 90, 95, 99)]
        wide = {w: int((e > w).sum()) for w in (16, 20, 24, 28, 32, 40)}
        print(f"      reach-ext pct p50/90/95/99={pct}  #groups>W: {wide}")


if __name__ == "__main__":
    for spec in sys.argv[1:] or ["n=262144,init=uniform"]:
        kw = {}
        for kv in spec.split(","):
            k, v = kv.split("=")
            kw[k] = v if k == "init" else int(v)
        run(**kw)
        print()
