"""Slope-timed grouped-BH step benchmark (see PERF.md methodology)."""

import functools
import sys
import time


import jax
import jax.numpy as jnp
import numpy as np

from nbody.ops.bh_grouped import bh_accelerations_grouped

G = 6.67e-11


def bench(n, gs, gc, **kw):
    rng = np.random.default_rng(0)
    masses = jnp.asarray(
        10 ** rng.uniform(-1, np.log10(0.5), n), jnp.float32
    )
    kw = dict(group_size=gs, group_chunk=gc, **kw)
    _, ovf = bh_accelerations_grouped(
        jnp.asarray(rng.uniform(-0.1, 0.1, (n, 2)), jnp.float32),
        masses,
        g=G,
        theta=0.5,
        return_diagnostics=True,
        **kw,
    )
    novf = int(np.asarray(ovf).sum())

    @functools.partial(jax.jit, static_argnames=("k",))
    def chain(positions, k):
        def body(p, _):
            return (
                p
                + bh_accelerations_grouped(p, masses, g=G, theta=0.5, **kw),
                None,
            )

        p, _ = jax.lax.scan(body, positions, None, length=k)
        return jnp.sum(p)

    def fresh():
        return jnp.asarray(rng.uniform(-0.1, 0.1, (n, 2)), jnp.float32)

    for k in (2, 8):
        float(chain(fresh(), k))
    ts = {}
    for k in (2, 8):
        best = 1e9
        for _ in range(2):
            p = fresh()
            t0 = time.perf_counter()
            float(chain(p, k))
            best = min(best, time.perf_counter() - t0)
        ts[k] = best
    print(
        f"N={n} gs={gs} gc={gc} {kw}: "
        f"{(ts[8]-ts[2])/6*1e3:.2f} ms/step, ovf={novf}",
        flush=True,
    )


if __name__ == "__main__":
    for spec in sys.argv[1:]:
        parts = dict(kv.split("=") for kv in spec.split(","))
        n = int(parts.pop("n", 65536))
        gs = int(parts.pop("gs", 256))
        gc = int(parts.pop("gc", 16))
        bench(n, gs, gc, **{k: int(v) for k, v in parts.items()})
