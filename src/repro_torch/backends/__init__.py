"""repro_torch.backends — the unified backend registry of the port.

One :class:`Backend` protocol (``mttkrp`` / ``matmul`` / ``cost`` /
``capabilities``), one registry (:func:`register` / :func:`get` /
:func:`list_backends`), and the implementations ported so far: ``"exact"``
(float baseline) and ``"hopper"`` (the hand-written CUDA kernel family —
the reference package's ``"pallas"`` backend). Still to come from the
reference: ``"psram-oracle"``, ``"psram-scheduled"``, ``"psram-stream"``,
``"psram-mesh"``, ``"analytical"``, and ``describe``.
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
from .workload import MatmulWorkload, MTTKRPProblem, normalize_mttkrp_data

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
    "get",
    "list_backends",
    "normalize_mttkrp_data",
    "RESOLVED_LOWERINGS",
    "register",
    "resolve_config",
    "resolve_lowering",
]
