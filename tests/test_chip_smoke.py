"""chip_smoke.py's phases at tiny sizes on the CPU (kernel in interpret
mode): the control flow, the reference comparisons and the checks that
fail a phase, without a card."""

import numpy as np
import pytest

import chip_smoke as cs


@pytest.mark.parametrize("dims", [2, 3])
def test_phase_allpairs(dims):
    rec = cs.phase_allpairs(256, dims=dims, reps=1, interpret=True)
    assert rec["ms_per_step"] > 0 and rec["xla_ms_per_step"] > 0
    assert rec["overflow"] == 0
    assert rec["memory"]["output_size_in_bytes"] == 256 * dims * 4


def test_phase_cli_allpairs():
    rec = cs.phase_cli_allpairs(512, steps=2)
    assert rec["ms_per_step"] >= 0 and rec["overflow"] == 0


@pytest.mark.parametrize("dims,sample", [(2, None), (3, 256)])
def test_phase_bh(dims, sample):
    rec = cs.phase_bh(2048, dims=dims, steps=2, sample=sample)
    assert rec["overflow"].startswith("0 at step 0, 0 at")


def test_phase_bh_fails_on_overflow(monkeypatch):
    """A phase whose traversal caps overflow fails, it is not reported
    as a pass: caps far too small for the cloud."""
    from nbody.config import SimConfig

    real = SimConfig

    def tiny_caps(**kw):
        return real(**kw, frontier_cap=16, list_cap=64, group_size=256)

    monkeypatch.setattr("nbody.config.SimConfig", tiny_caps)
    with pytest.raises(AssertionError, match="overflowed"):
        cs.phase_bh(2048, dims=2, steps=1)


def test_multi_card_fake_mesh(monkeypatch):
    """Every sharded mode on 4 of the 8 fake devices against the
    single-device step: errors within the tests' tolerances, outputs on
    all 4 devices.  The CPU reports no memory limit, so ``auto`` sees an
    80 GB card's."""
    monkeypatch.setattr(
        "nbody.parallel.memory.device_memory_bytes", lambda: 80 * 10**9
    )
    results = cs.multi_card(n2=1024, n3=2048, n_cards=4, steps=2)
    assert {r["mode"] for r in results} == {
        m for m, *_ in cs.MULTI_CARD_MODES
    }
    for r in results:
        assert r["spans"] == 4 and not any(r["overflow"])
        assert r["err"] <= r["tol"]
        assert r["force_err"] <= r["force_tol"]


@pytest.mark.parametrize(
    "n,dims,shape",
    [(1 << 20, 3, (128, 128, 64)), (262144, 2, (512, 512)),
     (2048, 3, (16, 16, 8))],
)
def test_grid_shape(n, dims, shape):
    assert cs.grid_shape(n, dims) == shape


def test_grid_shape_needs_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        cs.grid_shape(1000, 3)


def test_jittered_grid_is_morton_sorted_and_bounded():
    m, p, v = cs.jittered_grid((16, 16, 16))
    assert p.shape == (4096, 3) and m.shape == (4096,)
    assert np.abs(p).max() <= 0.1
    # one body per cell: no two bodies closer than half a cell
    cell = 0.2 / 16
    d = np.linalg.norm(p[1:] - p[:-1], axis=1)
    assert d.min() >= 0.5 * cell * (1 - 1e-5)
