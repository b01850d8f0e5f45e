"""nbody — a gravitational N-body framework for NVIDIA GPUs.

Built from scratch in JAX/XLA/Pallas with the capabilities of the reference
CPU/CUDA Barnes-Hut pipeline (DavidSevic/gpu-nbody-simulation; structural
analysis in SURVEY.md): an O(N^2) all-pairs engine as a tiled Pallas
interaction kernel, a Barnes-Hut engine rebuilt as a dense implicit
quadtree pyramid + stackless masked theta-traversal, a fused semi-implicit
Euler integrator, the reference's exact text-file contracts, and multi-chip
body sharding over a data-parallel mesh.
"""

from .config import InitRanges, MeshConfig, SimConfig
from .physics import integrate, kinetic_energy, potential_energy, total_momentum
from .rng import random_state
from .state import SimState, make_state

__version__ = "0.1.0"

__all__ = [
    "InitRanges",
    "MeshConfig",
    "SimConfig",
    "SimState",
    "integrate",
    "kinetic_energy",
    "make_state",
    "potential_energy",
    "random_state",
    "total_momentum",
]
