"""float64 policy: no silent f32 physics behind a float64 config.

The reference is all-f64 (project.cu:38-43).  The all-pairs kernel is
f32-only, so the framework must either refuse or route — never silently
downcast (round-2 verdict item 5).
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody.config import SimConfig
from nbody.models.engines import make_accel_fn
from nbody.ops.allpairs import allpairs_accelerations
from nbody.physics import (
    pair_accelerations_chunked,
    pair_accelerations_dense,
)

G = 6.67e-11


@contextlib.contextmanager
def _x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _cloud(n, seed=3, dtype=np.float32):
    rng = np.random.default_rng(seed)
    masses = (10 ** rng.uniform(-1, np.log10(0.5), n)).astype(dtype)
    positions = rng.uniform(-0.1, 0.1, (n, 2)).astype(dtype)
    return masses, positions


def test_allpairs_kernel_refuses_float64():
    """The kernel must raise (not silently cast) on f64 inputs."""
    with _x64():
        masses, positions = _cloud(640, dtype=np.float64)
        with pytest.raises(ValueError, match="f32-only"):
            allpairs_accelerations(
                jnp.asarray(positions, jnp.float64),
                jnp.asarray(masses, jnp.float64),
                g=G,
            )


def test_float64_config_routes_to_chunked_dense():
    """engine='allpairs' + dtype='float64' must produce true f64 physics
    (the chunked dense route), matching the dense f64 computation."""
    with _x64():
        masses, positions = _cloud(1024, dtype=np.float64)
        cfg = SimConfig(n_bodies=1024, engine="allpairs", dtype="float64")
        accel = make_accel_fn(cfg)
        p = jnp.asarray(positions, jnp.float64)
        m = jnp.asarray(masses, jnp.float64)
        got = accel(p, m)
        assert got.dtype == jnp.float64
        want = pair_accelerations_dense(p, m, g=G, softening=0.0)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), rtol=1e-12
        )


@pytest.mark.parametrize("softening", [0.0, 1e-15])
def test_chunked_matches_dense(softening):
    masses, positions = _cloud(700)  # deliberately not a chunk multiple
    p = jnp.asarray(positions)
    m = jnp.asarray(masses)
    got = pair_accelerations_chunked(
        p, m, g=G, softening=softening, chunk=256
    )
    want = pair_accelerations_dense(p, m, g=G, softening=softening)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=2e-5, atol=0
    )


@pytest.mark.parametrize("dims", [2, 3])
def test_f32_references_pinned_to_f64(dims):
    """The float32 references the kernels are held to (dense, chunked)
    agree with a float64 sum to f32 accumulation error, and their pair
    contraction asks for HIGHEST precision: a float32 dot may otherwise
    run in TF32 on the GPU (about three decimal digits), which no CPU run
    would show."""
    rng = np.random.default_rng(dims)
    n = 768
    p = rng.uniform(-0.1, 0.1, (n, dims)).astype(np.float32)
    m = (10 ** rng.uniform(-1, np.log10(0.5), n)).astype(np.float32)
    p64, m64 = p.astype(np.float64), m.astype(np.float64)
    disp = p64[None, :, :] - p64[:, None, :]
    d2 = np.sum(disp * disp, axis=-1)
    np.fill_diagonal(d2, np.inf)
    want = G * np.einsum("ij,ijk->ik", m64[None, :] / d2**1.5, disp)
    norm = np.linalg.norm(want, axis=1)
    for fn in (pair_accelerations_dense, pair_accelerations_chunked):
        got = np.asarray(fn(jnp.asarray(p), jnp.asarray(m), g=G))
        assert (np.linalg.norm(got - want, axis=1) / norm).max() < 2e-5
        jaxpr = str(jax.make_jaxpr(functools.partial(fn, g=G))(p, m))
        assert "dot_general" in jaxpr
        assert "precision=(Precision.HIGHEST, Precision.HIGHEST)" in jaxpr
