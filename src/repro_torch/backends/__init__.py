"""repro_torch.backends — the unified backend registry of the port.

One :class:`Backend` protocol (``mttkrp`` / ``matmul`` / ``cost`` /
``capabilities``), one registry (:func:`register` / :func:`get` /
:func:`list_backends`), and the implementations: ``"exact"`` (float
baseline), ``"psram-oracle"`` (the per-cycle array matmul and the quantized
chain), ``"psram-scheduled"`` (the tile-schedule executor and the §IV dense
mapping), ``"psram-stream"`` (the streaming schedule with the quantized
chain, eager and compiled), ``"hopper"`` (the hand-written CUDA kernel
family — the reference package's ``"pallas"`` backend), ``"psram-mesh"``
(the streaming schedule over many arrays) and the cost-only
``"analytical"``. :func:`describe` turns raw data into the cost descriptor
``api.estimate`` prices. Every backend of the reference's registry is
ported.
"""
from .base import (
    Backend,
    BackendError,
    Capabilities,
    CapabilityError,
    Estimate,
    UnknownBackendError,
    get,
    list_backends,
    register,
    resolve_config,
)
from .lowering import KERNEL_LOWERINGS, RESOLVED_LOWERINGS, resolve_lowering
from .workload import MatmulWorkload, MTTKRPProblem, describe, normalize_mttkrp_data

__all__ = [
    "Backend",
    "BackendError",
    "Capabilities",
    "CapabilityError",
    "Estimate",
    "KERNEL_LOWERINGS",
    "MatmulWorkload",
    "MTTKRPProblem",
    "UnknownBackendError",
    "describe",
    "get",
    "list_backends",
    "normalize_mttkrp_data",
    "RESOLVED_LOWERINGS",
    "register",
    "resolve_config",
    "resolve_lowering",
]
