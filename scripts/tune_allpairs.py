"""Time the all-pairs kernel's tile shapes and launch parameters on a GPU.

    python scripts/tune_allpairs.py [--n 65536] [--dims 2 3]

For each (target_block, source_block, num_warps, num_stages) it compiles
the kernel at N bodies, checks it against the plain XLA pair sum and
prints the median of 5 ``block_until_ready``-ended calls, then times the
plain XLA pair sum (float32, HIGHEST precision) once for comparison.  The
winners become ``ops/allpairs.py``'s defaults; record them in PERF.md
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import functools
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIGS = (  # target_block, source_block, num_warps, num_stages
    (64, 16, 4, 2),
    (64, 32, 4, 2),
    (64, 32, 8, 2),
    (64, 64, 8, 2),
    (128, 16, 4, 2),
    (128, 16, 8, 2),
    (128, 32, 4, 2),
    (128, 32, 8, 2),
    (128, 64, 8, 2),
    (256, 16, 8, 2),
    (256, 32, 8, 2),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--dims", type=int, nargs="+", default=[2, 3])
    args = ap.parse_args(argv)

    import jax
    import numpy as np

    from nbody.bench.headline import device_label, time_call
    from nbody.config import SimConfig
    from nbody.device import enable_compile_cache, require_gpu
    from nbody.ops.allpairs import allpairs_accelerations
    from nbody.physics import pair_accelerations_chunked
    from nbody.rng import random_state

    enable_compile_cache()
    require_gpu()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"{device_label()} nvidia-smi: {smi}", flush=True)
    g = 6.67e-11
    n = args.n
    for dims in args.dims:
        st = random_state(SimConfig(n_bodies=n, n_dim=dims))
        pos, m = st.positions, st.masses
        with jax.default_matmul_precision("highest"):
            xla = jax.jit(functools.partial(pair_accelerations_chunked, g=g))
            setup, t_xla, want = time_call(xla, pos, m)
        want = np.asarray(want)
        print(
            f"dims={dims} n={n} xla: setup {setup:.2f} s, "
            f"{t_xla * 1e3:.3f} ms", flush=True,
        )
        for tb, sb, warps, stages in CONFIGS:
            fn = jax.jit(functools.partial(
                allpairs_accelerations, g=g, target_block=tb,
                source_block=sb, num_warps=warps, num_stages=stages,
            ))
            try:
                setup, t, got = time_call(fn, pos, m)
            except Exception as e:  # report and go on to the next shape
                print(f"dims={dims} {tb}x{sb} w{warps} s{stages}: FAILED "
                      f"{type(e).__name__}: {str(e)[:300]}", flush=True)
                continue
            err = float(
                np.abs(np.asarray(got) - want).max() / np.abs(want).max()
            )
            print(
                f"dims={dims} {tb}x{sb} w{warps} s{stages}: setup "
                f"{setup:.2f} s, {t * 1e3:.3f} ms, "
                f"{n * n / t / 1e9:.1f} Gpairs/s, x{t_xla / t:.2f} vs xla, "
                f"err {err:.2e}", flush=True,
            )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
