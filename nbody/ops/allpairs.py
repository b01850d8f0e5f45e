"""Tiled all-pairs gravity kernel (Pallas through Triton, NVIDIA Hopper).

Replaces the reference's O(N^2) engines: the CPU triple loop
(main_approach_1.cpp:53-75) and the thread-per-body CUDA mapping
(project.cu:703).  Each pair costs ~20 FP32 operations and one ``rsqrt``
and moves almost no bytes once a source tile is on chip, so the kernel is
bound by the FP32 and special-function units:

* a 1-D parallel grid over target blocks; a program holds its
  ``target_block`` targets in registers;
* the whole source sweep is a ``lax.fori_loop`` nest inside the program,
  one ``source_block`` tile per iteration, accumulating a ``[TB, SB]``
  tile per axis in the loop carry (the outer chain Kahan-compensated with
  ``compensated=True``) and reducing it across lanes once, at the end;
* sources are SoA rows ``[D+1, Ns_pad]`` = (x, y[, z], g*m), padded with a
  far sentinel position and zero mass so no masks are needed.

The force reduction is a per-target row sum of w*(p_s - p_t): a matmul
formulation ``(W @ x_s) - x_t * (W @ 1)`` would cancel catastrophically
(W is dominated by nearest neighbours where x_s ~= x_t).

Semantics vs reference:
* softening == 0.0 -> main_approach_1.cpp factoring G*m_j/d^3 * disp.
* softening == eps -> Barnes-Hut leaf-pair factoring with the softened
  distance: G*m_j / (d2 * (sqrt(d2)+eps)) * disp (project.cu:651-658).
* Self-interaction is excluded exactly by the d2 > 0 guard (a body has zero
  displacement from itself).  Deviation: the reference naive engine emits
  inf/NaN for *distinct* coincident bodies (no softening, 1/d^2 at d=0,
  main_approach_1.cpp:66-67); we define that force as 0 instead.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

# Sentinel position for padded bodies: far enough that 1/d^3 underflows to
# zero against any real body, small enough that d^2 stays finite in f32.
_PAD_SENTINEL = 1e15

# Tile shape and launch parameters, chosen by a sweep on an H100 (PERF.md;
# scripts/tune_allpairs.py): the best tile that is within a few per cent
# of the best in both 2D and 3D.  Powers of two (Triton's block model);
# 64K targets give 1,024 programs for 132 SMs.
TARGET_BLOCK = 64
SOURCE_BLOCK = 32
NUM_WARPS = 8
NUM_STAGES = 2
# Source tiles summed per inner loop before joining the outer chain.
INNER_TILES = 32


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _allpairs_kernel(
    tgt_ref,  # [D, TB] this program's targets (SoA)
    src_ref,  # [D+1, Ns_pad] all sources: coordinate rows, then g*m
    out_ref,  # [D, TB] accelerations
    *,
    dims: int,
    softening: float,
    source_block: int,
    inner: int,
    n_outer: int,
    compensated: bool,
):
    tgt = [tgt_ref[d, :][:, None] for d in range(dims)]  # [TB, 1] each

    def tile(j):
        cols = pl.ds(pl.multiple_of(j * source_block, source_block),
                     source_block)
        disp = []
        d2 = None
        for d in range(dims):
            # direct subtraction, not the |a|^2+|b|^2-2ab identity: no
            # cancellation for close pairs
            da = src_ref[d, cols][None, :] - tgt[d]  # [TB, SB]
            disp.append(da)
            d2 = da * da if d2 is None else d2 + da * da
        gm = src_ref[dims, cols][None, :]
        inv_d = jax.lax.rsqrt(d2)
        if softening:
            w = gm / (d2 * (d2 * inv_d + softening))
        else:
            w = gm * (inv_d * inv_d * inv_d)
        w = jnp.where(d2 > 0.0, w, 0.0)  # kills self-pairs exactly
        return [w * da for da in disp]

    # The carry is a [TB, SB] tile per axis: each lane accumulates its own
    # column of sources, so the loop is all FMAs and the one cross-lane
    # reduction happens after it.  Two levels keep each lane's sequential
    # chains short (``inner`` tiles, then ``n_outer`` partial tiles): one
    # chain of Ns / SB adds would cost ~20x the f32 error of a tree sum.
    zero = jnp.zeros((tgt[0].shape[0], source_block), jnp.float32)

    def inner_sum(o):
        def body(i, acc):
            return tuple(a + v for a, v in zip(acc, tile(o * inner + i)))

        return jax.lax.fori_loop(0, inner, body, (zero,) * dims)

    if compensated:
        # Kahan over the outer chain; the compensation rides in the carry
        def outer(o, carry):
            sums, comps = carry
            new_s, new_c = [], []
            for s, c, v in zip(sums, comps, inner_sum(o)):
                y = v - c
                t = s + y
                new_c.append((t - s) - y)
                new_s.append(t)
            return tuple(new_s), tuple(new_c)

        sums, comps = jax.lax.fori_loop(
            0, n_outer, outer, ((zero,) * dims, (zero,) * dims)
        )
        acc = [jnp.sum(s - c, axis=1) for s, c in zip(sums, comps)]
    else:
        def outer(o, sums):
            return tuple(s + v for s, v in zip(sums, inner_sum(o)))

        sums = jax.lax.fori_loop(0, n_outer, outer, (zero,) * dims)
        acc = [jnp.sum(s, axis=1) for s in sums]
    for d in range(dims):
        out_ref[d, :] = acc[d]


@functools.partial(
    jax.jit,
    static_argnames=(
        "g",
        "softening",
        "target_block",
        "source_block",
        "num_warps",
        "num_stages",
        "interpret",
        "compensated",
    ),
)
def allpairs_accelerations_vs(
    target_positions: jax.Array,  # (Nt, D), D = 2 or 3
    source_positions: jax.Array,  # (Ns, D)
    source_masses: jax.Array,  # (Ns,)
    *,
    g: float,
    softening: float = 0.0,
    target_block: int | None = None,
    source_block: int | None = None,
    num_warps: int = NUM_WARPS,
    num_stages: int = NUM_STAGES,
    interpret: bool = False,
    compensated: bool = False,
) -> jax.Array:
    """Accelerations of targets due to sources via the tiled kernel.

    Targets and sources may be different clouds — the multi-card DP / ring
    modes pass the local body block as targets and (a rotating slice of)
    the gathered global cloud as sources.  A target that also appears among
    the sources at bit-identical coordinates is self-excluded by the
    ``d2 > 0`` guard, so no index bookkeeping crosses device boundaries.
    ``None`` tiles are the module defaults.  Returns (Nt, D).
    """
    if any(
        a.dtype == jnp.float64
        for a in (target_positions, source_positions, source_masses)
    ):
        # never silently downcast a float64 request to f32 physics (the
        # reference is all-f64, project.cu:38-43); models.engines routes
        # float64 configs to the chunked XLA path instead
        raise ValueError(
            "the all-pairs kernel is f32-only; for float64 use "
            "physics.pair_accelerations_chunked (the engine route for "
            "dtype='float64'), the NumPy f64 oracle (nbody.models.oracle), "
            "or the native C++ engine"
        )
    target_block = target_block or TARGET_BLOCK
    source_block = source_block or SOURCE_BLOCK
    nt, dims = target_positions.shape
    ns = source_positions.shape[0]
    f32 = jnp.float32

    nt_pad = _round_up(max(nt, 1), target_block)
    n_tiles = -(-max(ns, 1) // source_block)
    inner = min(INNER_TILES, n_tiles)
    n_outer = -(-n_tiles // inner)
    ns_pad = n_outer * inner * source_block
    tgt = jnp.full((dims, nt_pad), _PAD_SENTINEL, f32)
    tgt = tgt.at[:, :nt].set(target_positions.astype(f32).T)
    src = jnp.full((dims + 1, ns_pad), _PAD_SENTINEL, f32)
    src = src.at[:dims, :ns].set(source_positions.astype(f32).T)
    src = src.at[dims].set(0.0)
    src = src.at[dims, :ns].set(
        jnp.asarray(g, f32) * source_masses.astype(f32)
    )

    kernel = functools.partial(
        _allpairs_kernel,
        dims=dims,
        softening=float(softening),
        source_block=source_block,
        inner=inner,
        n_outer=n_outer,
        compensated=compensated,
    )
    pairs = nt_pad * ns_pad
    out = pl.pallas_call(
        kernel,
        grid=(nt_pad // target_block,),
        in_specs=[
            pl.BlockSpec((dims, target_block), lambda i: (0, i)),
            pl.BlockSpec((dims + 1, ns_pad), lambda i: (0, 0)),
        ],
        out_specs=pl.BlockSpec((dims, target_block), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((dims, nt_pad), f32),
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        cost_estimate=pl.CostEstimate(
            flops=(6 * dims + 5) * pairs,
            bytes_accessed=4 * (2 * dims * nt_pad + (dims + 1) * ns_pad),
            transcendentals=pairs,
        ),
        interpret=interpret,
        name="allpairs_accelerations",
    )(tgt, src)
    return out[:, :nt].T


def allpairs_accelerations(
    positions: jax.Array,  # (N, D)
    masses: jax.Array,  # (N,)
    *,
    g: float,
    softening: float = 0.0,
    **kernel_kw,
) -> jax.Array:
    """Single-cloud O(N^2) accelerations (targets == sources)."""
    return allpairs_accelerations_vs(
        positions, positions, masses, g=g, softening=softening, **kernel_kw
    )
