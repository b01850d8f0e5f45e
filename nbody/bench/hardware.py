"""Published limits of the cards the benchmarks run on, keyed by the
``device_kind`` JAX reports.

Source: NVIDIA H100 Tensor Core GPU data sheet (SXM part, dense rates
without sparsity) and the NVIDIA Hopper architecture white paper.  The
rates assume the full 700 W power limit; a card set below it cannot hold
its top clock, so every measurement prints ``nvidia-smi``'s power limit
beside it.  A device that is not in the table is an error, not a default.
"""

from __future__ import annotations

_H100_SXM = dict(
    memory_bytes=80e9,
    hbm_bytes_per_s=3.35e12,
    f32_flops_per_s=67e12,  # outside the tensor cores
    nvlink_bytes_per_s=450e9,  # each way, to the other cards of the host
)

DEVICES = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}


def device_spec(device_kind: str) -> dict:
    """The published limits of ``device_kind``; ``ValueError`` if unknown."""
    try:
        return dict(DEVICES[device_kind])
    except KeyError:
        raise ValueError(
            f"no published limits for device {device_kind!r}; known: "
            f"{sorted(DEVICES)}"
        ) from None
