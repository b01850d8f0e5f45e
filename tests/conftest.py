"""Test harness: CPU backend with 8 fake devices.

Multi-card paths (DP all-gather, ring all-pairs, psum sharding) run without
a GPU by faking an 8-device mesh on the host platform — the strategy
SURVEY.md section 4 prescribes.  Must run before jax is imported.

Tests marked ``gpu`` need an NVIDIA GPU; the ``gpu`` fixture skips them
elsewhere.  Run them on the card with
``NBODY_TEST_PLATFORM=cuda python -m pytest tests -m gpu``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# The CPU unless NBODY_TEST_PLATFORM names another platform ("cuda" for
# the gpu-marked tests on the card).
import jax  # noqa: E402

jax.config.update(
    "jax_platforms", os.environ.get("NBODY_TEST_PLATFORM", "cpu")
)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first device, or skip: decided when the test runs, never at
    import (pytest-xdist workers must all collect the same tests)."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(
            "needs an NVIDIA GPU (NBODY_TEST_PLATFORM=cuda python -m "
            "pytest tests -m gpu)"
        )
    return device


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def small_cloud(rng):
    """A reference-like random body cloud (ranges from project.cu:30-35)."""
    n = 64
    masses = 10 ** rng.uniform(np.log10(1e-1), np.log10(5e-1), size=n)
    positions = rng.uniform(-1e-1, 1e-1, size=(n, 2))
    velocities = rng.uniform(-1e-4, 1e-4, size=(n, 2))
    return masses, positions, velocities
