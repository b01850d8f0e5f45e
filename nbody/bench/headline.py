"""The headline benchmark: all-pairs and grouped Barnes-Hut on one GPU.

Prints diagnostics on stderr and ONE JSON line on stdout (the last line):
``{"metric", "value", "unit", "vs_baseline", "platform", "device_kind",
"count"}``.  Every line names the device it ran on.  It runs only on an
NVIDIA GPU: without one it exits non-zero and prints no result.

Primary metric: all-pairs pairwise interactions per second on one card at
N=65,536 (the tiled kernel, ops/allpairs.py).  Baseline: the BASELINE.json
north star of 1e10 pairwise interactions/s at N=65,536 (derived from the
reference's best 64.999 ms / 10 steps Barnes-Hut at N=40,000 on an NVIDIA
T600, project_report.pdf p.24).  The grouped Barnes-Hut step (theta=0.5,
same N, tree build included) is reported on stderr.

Timing: the first call compiles and is reported as set-up time; each
timed call ends in ``block_until_ready``; the step time is the median of
``REPS`` calls.
"""

from __future__ import annotations

import json
import sys
import time

N_HEADLINE = 65536
REPS = 5


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def device_label() -> dict:
    """platform / device_kind / count of the devices JAX sees."""
    import jax

    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "count": len(devices),
    }


def time_call(fn, *args, reps: int = REPS):
    """``(setup_s, median_s, out)``: the first call (compilation included)
    and the median of ``reps`` further calls of ``fn(*args)``, each ended
    by ``block_until_ready``."""
    import jax
    import numpy as np

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    setup = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return setup, float(np.median(times)), out


def measure(n: int = N_HEADLINE) -> dict:
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from ..config import G_DEFAULT
    from ..ops.allpairs import allpairs_accelerations
    from ..ops.bh_grouped import bh_accelerations_grouped

    label = device_label()
    rng = np.random.default_rng(0)
    masses = jnp.asarray(10 ** rng.uniform(-1, np.log10(0.5), n), jnp.float32)
    pos = jnp.asarray(rng.uniform(-0.1, 0.1, (n, 2)), jnp.float32)

    ap = jax.jit(functools.partial(allpairs_accelerations, g=G_DEFAULT))
    setup, step, _ = time_call(ap, pos, masses)
    pairs_per_sec = n * n / step
    log(
        f"bench[allpairs] {label}: n={n} setup {setup:.2f} s, "
        f"{step * 1e3:.3f} ms/step (median of {REPS}), "
        f"{pairs_per_sec / 1e9:.1f} Gpairs/s"
    )

    bh = jax.jit(
        functools.partial(
            bh_accelerations_grouped, g=G_DEFAULT, theta=0.5,
            return_diagnostics=True,
        )
    )
    setup, step_bh, (_, ovf) = time_call(bh, pos, masses)
    log(
        f"bench[BH] {label}: grouped theta=0.5 n={n} setup {setup:.2f} s, "
        f"{step_bh * 1e3:.3f} ms/step incl. tree build (median of {REPS}), "
        f"overflow {int(np.asarray(ovf).sum())} bodies"
    )
    return {
        "metric": f"allpairs_pairwise_interactions_per_sec_n{n}",
        "value": pairs_per_sec,
        "unit": "pairs/s/card",
        "vs_baseline": pairs_per_sec / 1e10,
        **label,
    }


def main() -> int:
    from ..device import enable_compile_cache, require_gpu

    enable_compile_cache()
    require_gpu()
    print(json.dumps(measure()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
