"""Dense (window-stencil) 3D collector vs the gather walk.

The dense collector (ops/collect_dense3.py) must be a drop-in for
``bh3d._collect_lists_3d``: identical cell classification (exact list
parity up to compaction order), identical body ranges, and the
escape -> spill -> overflow ladder in place of frontier caps.  The
spatial pyramid's Morton-prefix field must agree with the Morton
tree's ``leaf_cum`` (the gather walk's direct-range source).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody.ops.bh3d import (
    _collect_lists_3d,
    bh3_accelerations_grouped,
    cap_defaults_3d,
    direct_cell_max_default,
    frontier_schedule_3d,
)
from nbody.ops.collect_dense3 import (
    build_spatial_pyramid,
    collect_lists_3d_dense,
    window_schedule_3d,
)
from nbody.ops.tree3d import build_octree, default_max_depth3

G = 6.67e-11


def _cloud(n, seed=0, blobs=False):
    rng = np.random.default_rng(seed)
    m = 10 ** rng.uniform(-1, np.log10(0.5), n)
    if blobs:
        k = n // 2
        c = rng.uniform(-0.05, 0.05, (2, 3))
        pts = np.concatenate([
            rng.normal(c[0], 0.004, (k, 3)),
            rng.normal(c[1], 0.004, (n - k, 3)),
        ])
        p = np.clip(pts, -0.1, 0.1)
    else:
        p = rng.uniform(-0.1, 0.1, (n, 3))
    return jnp.asarray(m, jnp.float32), jnp.asarray(p, jnp.float32)


def _setup(n, seed=0, blobs=False, gs=2048):
    m, p = _cloud(n, seed, blobs)
    md = default_max_depth3(n)
    tree = build_octree(p, m, max_depth=md)
    spyr = build_spatial_pyramid(p, m, tree.bounds, md)
    ps = p[jnp.argsort(tree.codes)]
    g = n // gs
    q = gs // 128
    sub = ps.reshape(g, q, gs // q, 3)
    bbox = (
        sub[..., 0].min(2), sub[..., 0].max(2),
        sub[..., 1].min(2), sub[..., 1].max(2),
        sub[..., 2].min(2), sub[..., 2].max(2),
    )
    caps = cap_defaults_3d(n)
    kw = dict(
        theta=0.5,
        softening=1e-15,
        list_cap=caps["list_cap"],
        direct_cap=caps["direct_cap"],
        direct_cell_max=direct_cell_max_default(n),
    )
    fcaps = frontier_schedule_3d(caps["frontier_cap"], md, n)
    return m, p, tree, spyr, bbox, fcaps, kw, g


def _assert_group_parity(gath, dense, gi):
    (glm, granges), (dlm, dranges) = gath, dense
    a = np.sort(np.asarray(glm[gi])[np.asarray(glm[gi]) > 0])
    b = np.sort(np.asarray(dlm[gi])[np.asarray(dlm[gi]) > 0])
    assert len(a) == len(b), (gi, len(a), len(b))
    np.testing.assert_allclose(a, b, rtol=1e-5)
    ra = np.asarray(granges[gi])
    rb = np.asarray(dranges[gi])
    ra = ra[ra[:, 1] > 0]
    rb = rb[rb[:, 1] > 0]
    ra = ra[np.lexsort(ra.T)]
    rb = rb[np.lexsort(rb.T)]
    assert ra.shape == rb.shape and (ra == rb).all(), gi


def test_spatial_prefix_matches_leaf_cum():
    """The pyramid's Morton body prefix (the no-gather replacement for
    the gather walk's leaf_cum lookup) must equal leaf_cum cell for
    cell after de-interleaving."""
    n = 4096
    m, p = _cloud(n, seed=2)
    md = default_max_depth3(n)
    tree = build_octree(p, m, max_depth=md)
    spyr = build_spatial_pyramid(p, m, tree.bounds, md)
    leaf_cnt = np.asarray(tree.leaf_counts())
    leaf_cum = np.concatenate([[0], np.cumsum(leaf_cnt)])[:-1]
    d = 1 << md
    start = np.asarray(spyr.start[md])
    idx = np.arange(8**md, dtype=np.int64)
    cx = np.zeros_like(idx)
    cy = np.zeros_like(idx)
    cz = np.zeros_like(idx)
    for k in range(md):
        cx |= ((idx >> (3 * k)) & 1) << k
        cy |= ((idx >> (3 * k + 1)) & 1) << k
        cz |= ((idx >> (3 * k + 2)) & 1) << k
    np.testing.assert_array_equal(start[cx, cy, cz], leaf_cum)
    # counts agree too (same scatter through a different code path)
    grid_cnt = np.asarray(spyr.grid[md][..., 4])
    np.testing.assert_array_equal(grid_cnt[cx, cy, cz], leaf_cnt)


@pytest.mark.slow
def test_dense_collector_exact_parity_uniform():
    """Default windows, uniform cloud: identical lists/ranges per group
    (set-wise; compaction order may differ), no overflow, and the
    window schedule respects nesting (W[l] <= 2*W[l-1])."""
    n = 8192
    _, _, tree, spyr, bbox, fcaps, kw, g = _setup(n)
    sched = window_schedule_3d(spyr.max_depth)
    assert all(
        sched[i] <= 2 * sched[i - 1] for i in range(1, len(sched))
    )
    (_, _, _, glm), granges, govf = _collect_lists_3d(
        bbox, tree, frontier_caps=fcaps, **kw
    )
    (_, _, _, dlm), dranges, dovf = collect_lists_3d_dense(
        bbox, tree, spyr, frontier_caps=fcaps, **kw
    )
    assert int(np.asarray(govf).sum()) == 0
    assert int(np.asarray(dovf).sum()) == 0
    for gi in range(g):
        _assert_group_parity((glm, granges), (dlm, dranges), gi)


@pytest.mark.slow
def test_dense_collector_spill_parity():
    """Forced-tiny windows escape every group: the spill pass must
    restore exact parity for every group whose demand fits the spill
    caps, and spill_cap=0 must surface escapes as overflow."""
    n = 16384
    _, _, tree, spyr, bbox, fcaps, kw, g = _setup(n)
    md = spyr.max_depth
    sched = tuple((1, 2, 4, 6, 6, 6, 6, 6, 6, 6)[: md + 1])
    (_, _, _, glm), granges, _ = _collect_lists_3d(
        bbox, tree, frontier_caps=fcaps, **kw
    )
    (_, _, _, slm), sranges, sovf = collect_lists_3d_dense(
        bbox, tree, spyr, frontier_caps=fcaps,
        window_schedule=sched, spill_cap=g, **kw
    )
    sovf = np.asarray(sovf)
    checked = 0
    for gi in range(g):
        if sovf[gi]:  # spill demand beyond the (dense-width) caps
            continue
        _assert_group_parity((glm, granges), (slm, sranges), gi)
        checked += 1
    assert checked >= g // 2

    _, _, oovf = collect_lists_3d_dense(
        bbox, tree, spyr, frontier_caps=fcaps,
        window_schedule=sched, spill_cap=0, **kw
    )
    assert int(np.asarray(oovf).sum()) > 0


def test_resolve_collect_auto_gate():
    """The auto gate ships dense at N >= 256K (measured 1.3-1.9x wins,
    PERF.md round 5) and keeps the gather walk below (measured losses
    at 64K/128K); explicit modes pass through; junk rejects."""
    from nbody.ops.bh3d import DENSE_COLLECT_MIN_N, _resolve_collect

    assert DENSE_COLLECT_MIN_N == 262144
    assert _resolve_collect(None, 262144) == "dense"
    assert _resolve_collect(None, 1048576) == "dense"
    assert _resolve_collect(None, 262143) == "gather"
    assert _resolve_collect(None, 65536) == "gather"
    assert _resolve_collect("auto", 524288) == "dense"
    assert _resolve_collect("gather", 1048576) == "gather"
    assert _resolve_collect("dense", 1024) == "dense"
    with pytest.raises(ValueError):
        _resolve_collect("slabs", 65536)


def test_spill_cap_auto_has_absolute_floor():
    """Auto spill budget = max(48, G//4), clamped to G: the measured
    blob escape COUNT is ~constant in G (blob geometry sets it — 18
    groups at 256K/gs=2048, 17 at 256K/gs=4096, 35 at 1M), so a
    G-proportional-only budget under-provisions exactly when groups
    get fatter (G//4 = 16 < 17 at G=64 forced the 4x adaptive retry on
    every contract step).  Tiny-window escape storm: the clamped auto
    budget (G=32 here, so min(48, G) = G) must rescue every group the
    explicit spill_cap=g run rescues."""
    n = 16384
    _, _, tree, spyr, bbox, fcaps, kw, g = _setup(n, gs=512)
    md = spyr.max_depth
    sched = tuple((1, 2, 4, 6, 6, 6, 6, 6, 6, 6)[: md + 1])
    _, _, ovf_auto = collect_lists_3d_dense(
        bbox, tree, spyr, frontier_caps=fcaps,
        window_schedule=sched, **kw
    )
    # here G=32 < the 48 floor, so auto clamps to a full-G budget:
    # byte-identical to an explicit spill_cap=g run
    _, _, ovf_full = collect_lists_3d_dense(
        bbox, tree, spyr, frontier_caps=fcaps,
        window_schedule=sched, spill_cap=g, **kw
    )
    np.testing.assert_array_equal(
        np.asarray(ovf_auto), np.asarray(ovf_full)
    )
    # an under-floor explicit budget can only leave MORE overflow
    _, _, ovf_4 = collect_lists_3d_dense(
        bbox, tree, spyr, frontier_caps=fcaps,
        window_schedule=sched, spill_cap=4, **kw
    )
    assert int(np.asarray(ovf_4).sum()) >= int(
        np.asarray(ovf_auto).sum()
    )


def test_frontier_peak_3d_band():
    """The 4x cap scale moves ONLY the md-boundary band (92K, 143K]
    where a uniform 128K cloud persistently overflowed under the old
    3x scale (PERF.md round 5); every other tier is pinned."""
    from nbody.ops.bh3d import frontier_peak_3d

    assert frontier_peak_3d(65536) == 8192
    assert frontier_peak_3d(131072) == 16384  # was 8192: the squeeze
    assert frontier_peak_3d(262144) == 16384
    assert frontier_peak_3d(524288) == 32768
    assert frontier_peak_3d(1048576) == 32768


def test_default_group_size3_band():
    """group_size=None resolves 4096 exactly in the [256K, 768K) band
    (same-invocation A/Bs, PERF.md round 5: 256K uniform 1.36x, blobs
    1.49x, 512K 1.06x; 1M measured a LOSS so the band closes at the
    quarter-split boundary) and 2048 everywhere else."""
    from nbody.ops.bh3d import default_group_size3

    assert default_group_size3(65536) == 2048
    assert default_group_size3(262143) == 2048
    assert default_group_size3(262144) == 4096
    assert default_group_size3(524288) == 4096
    assert default_group_size3(786431) == 4096
    assert default_group_size3(786432) == 2048
    assert default_group_size3(1048576) == 2048


@pytest.mark.slow
@pytest.mark.parametrize("blobs", [False, True])
def test_dense_engine_accel_parity(blobs):
    """End to end through bh3_accelerations_grouped: dense vs gather
    accelerations agree to fp-reordering noise (the two pyramids sum
    cell aggregates in different orders), zero overflow both ways."""
    n = 16384
    m, p = _cloud(n, seed=1, blobs=blobs)
    ag, og = bh3_accelerations_grouped(
        p, m, g=G, theta=0.5,
        collect="gather", return_diagnostics=True,
    )
    ad, od = bh3_accelerations_grouped(
        p, m, g=G, theta=0.5,
        collect="dense", return_diagnostics=True,
    )
    assert int(np.asarray(og).sum()) == 0
    assert int(np.asarray(od).sum()) == 0
    ag, ad = np.asarray(ag), np.asarray(ad)
    num = np.linalg.norm(ad - ag, axis=1)
    den = np.linalg.norm(ag, axis=1) + 1e-30
    assert (num / den).max() < 1e-4
