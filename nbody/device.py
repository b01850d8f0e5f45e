"""Which device the program runs on, decided in one place.

* :func:`kernel_route` maps JAX's platform to the code path the engines
  take: ``"gpu"`` runs the hand-written Pallas/Triton kernels compiled for
  the card, ``"cpu"`` runs the plain XLA formulations.  Any other platform
  is an error: there is no silent fallback that would hide which device a
  number came from.  Production code never selects Pallas interpret mode;
  only tests pass ``interpret=True`` to a kernel.
* :func:`require_gpu` is the measurement entry points' guard (``bench.py``,
  ``chip_smoke.py``): JAX falls back to the CPU when the CUDA plugin fails
  to start, so a measurement that does not check would time the host.
* :func:`enable_compile_cache` points JAX's persistent compilation cache at
  a fixed directory before the first compile.
"""

from __future__ import annotations

import os

import jax

# <repo>/.jax_cache: a fixed path, because the cache key includes it.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def kernel_route(platform: str | None = None) -> str:
    """``"gpu"`` or ``"cpu"`` for the given (default: JAX's) platform."""
    platform = jax.default_backend() if platform is None else platform
    if platform in ("gpu", "cuda"):
        return "gpu"
    if platform == "cpu":
        return "cpu"
    raise ValueError(
        f"no kernel route for platform {platform!r}: this program runs on "
        "an NVIDIA GPU ('gpu') or, with plain XLA, on the CPU ('cpu')"
    )


def require_gpu() -> list:
    """The visible devices, or ``SystemExit`` (non-zero) without a GPU."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            "no GPU found: JAX's first device is "
            f"{devices[0].platform!r} ({devices[0].device_kind}); this "
            "measurement runs only on an NVIDIA GPU"
        )
    return devices


def enable_compile_cache() -> str:
    """Persist compiled programs; returns the cache directory.

    ``JAX_COMPILATION_CACHE_DIR`` wins when set (JAX reads it itself, so
    nothing is changed); otherwise the cache goes to ``<repo>/.jax_cache``.
    Must run before the first compile of the process."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
