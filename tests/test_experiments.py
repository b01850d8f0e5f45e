"""Unit tests for the unshipped merged-run pipeline (ops/experiments.py).

These utilities were measured end-to-end and lost to the shipped static
per-cell expansion (PERF.md "Morton run merging"); they stay tested so
the formulations remain reusable.
"""

import jax.numpy as jnp
import numpy as np

from nbody.ops.experiments import expand_runs_superblocks, merge_ranges


def test_merge_ranges_interval_union(rng):
    """merge_ranges must produce exactly the interval union per row."""
    g, d = 8, 64
    starts = rng.integers(0, 1000, (g, d)).astype(np.int32)
    counts = rng.integers(0, 40, (g, d)).astype(np.int32)
    counts[:, 50:] = 0  # padding tail
    merged, ovf = merge_ranges(
        jnp.stack([jnp.asarray(starts), jnp.asarray(counts)], -1)
    )
    merged = np.asarray(merged)
    assert not np.asarray(ovf).any()
    for row in range(g):
        ivs = sorted(
            (int(s), int(s + c))
            for s, c in zip(starts[row], counts[row]) if c > 0
        )
        union = []
        for s, e in ivs:
            if union and s <= union[-1][1]:
                union[-1] = (union[-1][0], max(union[-1][1], e))
            else:
                union.append((s, e))
        got = [
            (int(s), int(s + c))
            for s, c in merged[row] if c > 0
        ]
        assert got == union, (row, got[:5], union[:5])


def test_expand_runs_superblocks(rng):
    """Enumerated superblocks must cover each run exactly once with the
    right lane bounds."""
    ranges = np.zeros((2, 8, 2), np.int32)
    ranges[0, 0] = (3, 20)    # superblocks 0..2
    ranges[0, 1] = (64, 300)  # superblocks 8..45
    ranges[1, 0] = (8, 8)     # exactly superblock 1
    sb, lo, hi, ovf = (
        np.asarray(a)
        for a in expand_runs_superblocks(jnp.asarray(ranges), 64)
    )
    assert not ovf.any()
    row0 = [s for s in sb[0] if s >= 0]
    assert row0 == list(range(0, 3)) + list(range(8, 46))
    assert (lo[0][:3] == 3).all() and (hi[0][:3] == 23).all()
    assert (lo[0][3:41] == 64).all() and (hi[0][3:41] == 364).all()
    row1 = [s for s in sb[1] if s >= 0]
    assert row1 == [1]
    assert lo[1][0] == 8 and hi[1][0] == 16


def test_expand_runs_overflow_does_not_spill_across_groups():
    """A group whose superblock total exceeds sb_cap must flag overflow
    WITHOUT corrupting the next group's (non-overflowing) segment."""
    sb_cap = 4
    ranges = np.zeros((2, 3, 2), np.int32)
    # group 0: two runs totalling 6 superblocks > cap of 4
    ranges[0, 0] = (0, 24)     # superblocks 0..2
    ranges[0, 1] = (64, 24)    # superblocks 8..10 -> offsets 3..5 (spill)
    # group 1: one clean run
    ranges[1, 0] = (16, 8)     # exactly superblock 2
    sb, lo, hi, ovf = (
        np.asarray(a)
        for a in expand_runs_superblocks(jnp.asarray(ranges), sb_cap)
    )
    assert ovf.tolist() == [True, False]
    # group 0 keeps its first cap-worth of superblocks
    assert sb[0].tolist() == [0, 1, 2, 8]
    # group 1 is intact: its own single run, no marks leaked from group 0
    assert [s for s in sb[1] if s >= 0] == [2]
    assert lo[1][0] == 16 and hi[1][0] == 24
