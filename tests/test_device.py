"""One place decides the device route; the compile cache and the card
table have no silent defaults."""

import os

import jax
import pytest

from nbody import device
from nbody.bench.hardware import device_spec


@pytest.mark.parametrize(
    "platform,route", [("gpu", "gpu"), ("cuda", "gpu"), ("cpu", "cpu")]
)
def test_kernel_route(platform, route):
    assert device.kernel_route(platform) == route


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_kernel_route_unknown_platform_is_an_error(platform):
    with pytest.raises(ValueError, match="no kernel route"):
        device.kernel_route(platform)


def test_kernel_route_defaults_to_jax_backend():
    assert device.kernel_route() == "cpu"  # conftest pins the CPU


@pytest.fixture
def cache_dir_config():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_compile_cache_env_wins(monkeypatch, tmp_path, cache_dir_config):
    """JAX_COMPILATION_CACHE_DIR set: the helper returns it and sets
    nothing itself."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert device.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo(monkeypatch, cache_dir_config):
    """Unset: <repo>/.jax_cache, a fixed path (the path is part of the
    cache key), never one built from a temp dir, pid or time."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert device.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert device.enable_compile_cache() == want  # stable across calls


def test_h100_table():
    spec = device_spec("NVIDIA H100 80GB HBM3")
    assert spec["memory_bytes"] == 80e9
    assert spec["hbm_bytes_per_s"] == 3.35e12
    assert spec["f32_flops_per_s"] == 67e12
    assert spec["nvlink_bytes_per_s"] == 450e9


@pytest.mark.parametrize("kind", ["AMD Instinct MI300X", "cpu", ""])
def test_unknown_device_kind_is_an_error(kind):
    with pytest.raises(ValueError, match="no published limits"):
        device_spec(kind)
