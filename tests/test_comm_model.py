"""Per-mode communication-volume model vs the traced jaxpr.

The reference quantifies its per-step staging traffic (tree H2D every
step project.cu:968, positions D2H every step project.cu:1010; measured
in project_report.pdf p.22).  Our equivalent claims — grouped = O(N)
all_gather, sharded = O(N/devices + tree) — live in
parallel/memory.collective_inventory / comm_bytes_per_step; these tests
pin the inventory against the collectives the traced step ACTUALLY
issues (operand shapes from the jaxpr) and the asymptotics against the
model arithmetic.
"""

import jax
import numpy as np
import pytest

from nbody import SimConfig, make_state
from nbody.parallel import make_mesh, make_mesh_2d, make_sharded_step
from nbody.parallel.memory import (
    collective_inventory,
    comm_bytes_per_step,
    tree_bytes,
)

N = 1024
_COLL = ("all_gather", "ppermute", "psum", "pmin", "pmax", "all_to_all")


def _walk(jaxpr, found):
    for eqn in jaxpr.eqns:
        nm = eqn.primitive.name
        if any(k in nm for k in _COLL):
            for v in eqn.invars:
                aval = v.aval
                found.append(
                    (nm, int(np.prod(aval.shape, dtype=np.int64))
                     * aval.dtype.itemsize)
                )
        for val in eqn.params.values():
            vals = val if isinstance(val, (list, tuple)) else (val,)
            for x in vals:
                if hasattr(x, "eqns"):
                    _walk(x, found)
                elif hasattr(x, "jaxpr"):
                    _walk(x.jaxpr, found)
    return found


def _traced_inventory(mode, dims=2, mesh=None):
    cfg = SimConfig(n_bodies=N, n_dim=dims)
    rng = np.random.default_rng(0)
    m = rng.uniform(0.1, 0.5, N).astype(np.float32)
    p = rng.uniform(-0.1, 0.1, (N, dims)).astype(np.float32)
    v = np.zeros((N, dims), np.float32)
    state = make_state(m, p, v)
    mesh = mesh or make_mesh(8)
    step = make_sharded_step(cfg, mesh, mode)
    jx = jax.make_jaxpr(step)(state)
    return cfg, sorted(_walk(jx.jaxpr, []))


@pytest.mark.parametrize(
    "mode,dims",
    [
        ("dp_allpairs", 2),
        ("ring_allpairs", 2),
        ("dp_barnes_hut", 2),
        ("dp_barnes_hut_grouped", 2),
        ("dp_barnes_hut_sharded", 2),
        ("dp_barnes_hut_grouped3", 3),
        ("dp_barnes_hut_sharded3", 3),
    ],
)
def test_inventory_matches_jaxpr(mode, dims):
    """The analytic inventory must list exactly the collectives (and
    operand byte sizes) the traced step issues — nothing modeled that
    isn't real, nothing real that isn't modeled."""
    cfg, traced = _traced_inventory(mode, dims)
    want = sorted(
        (op, p) for op, p in collective_inventory(cfg, 8, mode)
    )
    assert traced == want


def test_inventory_matches_jaxpr_dp2d():
    cfg, traced = _traced_inventory(
        "dp2d_allpairs", 2, mesh=make_mesh_2d(4, 2)
    )
    want = sorted(
        (op, p) for op, p in collective_inventory(cfg, 4, "dp2d_allpairs", sp=2)
    )
    assert traced == want


def test_inventory_matches_jaxpr_two_devices():
    """n_dev == 2 is the single-halo special case in the sharded step."""
    cfg = SimConfig(n_bodies=N)
    rng = np.random.default_rng(0)
    state = make_state(
        rng.uniform(0.1, 0.5, N).astype(np.float32),
        rng.uniform(-0.1, 0.1, (N, 2)).astype(np.float32),
        np.zeros((N, 2), np.float32),
    )
    step = make_sharded_step(cfg, make_mesh(2), "dp_barnes_hut_sharded")
    traced = sorted(_walk(jax.make_jaxpr(step)(state).jaxpr, []))
    want = sorted(collective_inventory(cfg, 2, "dp_barnes_hut_sharded"))
    assert traced == want


def test_sharded_comm_is_o_n_over_devices_plus_tree():
    """The central claim of the sharded design (steps.py docstring):
    per-chip comm O(N/devices + tree).  Doubling N at fixed depth must
    grow sharded comm by exactly the two halo slabs' worth (N/D rows of
    [coords+gm] f32 + codes i32), while grouped grows by the full
    all_gathered cloud (D-1 forwarded slabs)."""
    d = 8
    base = SimConfig(n_bodies=1 << 18, max_depth=9)
    dbl = SimConfig(n_bodies=1 << 19, max_depth=9)

    sh = comm_bytes_per_step(base, d, "dp_barnes_hut_sharded")
    sh2 = comm_bytes_per_step(dbl, d, "dp_barnes_hut_sharded")
    slab_growth = (1 << 19) // d - (1 << 18) // d
    # two ppermuted halos: rows (x, y, g*m) f32 + codes i32 = 16 B/body
    assert sh2 - sh == 2 * slab_growth * 16

    gr = comm_bytes_per_step(base, d, "dp_barnes_hut_grouped")
    gr2 = comm_bytes_per_step(dbl, d, "dp_barnes_hut_grouped")
    # all_gather forwards (d-1) slabs of (x, y) f32 + mass f32 = 12 B
    assert gr2 - gr == (d - 1) * slab_growth * 12

    # and at weak-scaling N the sharded mode stays below grouped; its
    # SOURCE traffic is 32 B per owned body (two 16 B halo rows),
    # device-count-independent, while grouped forwards (d-1) x 12 B —
    # the gap that widens with the mesh
    big = SimConfig(n_bodies=1 << 22, max_depth=9)
    sh_total = comm_bytes_per_step(big, d, "dp_barnes_hut_sharded")
    gr_total = comm_bytes_per_step(big, d, "dp_barnes_hut_grouped")
    assert sh_total < gr_total
    sh_sources = sum(
        p for op, p in collective_inventory(big, d, "dp_barnes_hut_sharded")
        if op == "ppermute"
    )
    assert sh_sources == 2 * ((1 << 22) // d) * 16
    assert 2 * sh_sources < gr_total


def test_sharded_tree_term_is_n_independent():
    """The psum'd pyramid payload depends on depth only — the O(tree)
    term: same depth, 4x bodies, identical psum payloads."""
    a = SimConfig(n_bodies=1 << 16, max_depth=8)
    b = SimConfig(n_bodies=1 << 18, max_depth=8)
    pa = [p for op, p in collective_inventory(a, 8, "dp_barnes_hut")
          if op == "psum"]
    pb = [p for op, p in collective_inventory(b, 8, "dp_barnes_hut")
          if op == "psum"]
    assert pa == pb
    assert max(pa) == 4**8 * 8 * 4  # [4^depth, 8] f32 leaf table


def test_baseline_records_carry_comm_and_projection():
    """Round-4 missing #1/#2: configs 4/5 records must be
    self-describing — per-point comm bytes, the fake-mesh note, and a
    real-hardware projection derived from the devices=1 anchor."""
    from nbody.bench.baseline import (
        FAKE_MESH_NOTE,
        _annotate_comm_and_projection,
    )

    rec = {
        "config": 4,
        "points": [
            {"devices": d, "n": 262144, "step_seconds": 0.03}
            for d in (1, 2, 4, 8)
        ],
        "anchor_devices1_real_chip": {
            "devices": 1,
            "n": 262144,
            "step_seconds": 0.028,
            "tree_build_seconds": 0.003,
            "device_kind": "NVIDIA H100 80GB HBM3",
        },
    }
    _annotate_comm_and_projection(rec, weak=False)
    for pt in rec["points"]:
        assert pt["comm_bytes_per_step_per_chip"] == comm_bytes_per_step(
            SimConfig(n_bodies=pt["n"]), pt["devices"],
            "dp_barnes_hut_grouped",
        )
    proj = rec["projection_real_hardware"]
    assert proj["inputs"]["anchor_tree_build_seconds"] == 0.003
    p8 = proj["points"][-1]
    assert p8["devices"] == 8
    # Amdahl: the redundant tree build bounds the modeled speedup below
    # ideal — 0.028/(0.003 + 0.025/8) is the ceiling before comm
    assert p8["speedup"] < 0.028 / (0.003 + 0.025 / 8) + 1e-9
    assert p8["modeled_comm_seconds"] > 0
    # the note text names the expectation a cold reader needs
    assert "EXPECTED" in FAKE_MESH_NOTE


def test_comm_vs_storage_are_consistent():
    """tree_bytes (storage) covers the full pyramid; the comm term is
    the leaf level only — the model must keep them distinct (leaf psum
    payload < full pyramid storage)."""
    cfg = SimConfig(n_bodies=1 << 18, max_depth=9)
    leaf = max(
        p for op, p in collective_inventory(cfg, 8, "dp_barnes_hut_sharded")
        if op == "psum"
    )
    assert leaf < tree_bytes(cfg)
