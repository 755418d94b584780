"""repro_torch.api — the estimate/execute facade over the backend registry.

One workload union, one config, one backend name:

>>> from repro_torch import api
>>> est = api.estimate(MTTKRPWorkload(), backend="analytical")     # §V model
>>> out = api.execute(api.MTTKRPProblem(coo, factors, mode=0),
...                   backend="psram-stream")                       # runs it
>>> y   = api.matmul(x, w, backend="psram-scheduled")               # array matmul
>>> a   = api.mttkrp(x3, factors, mode=1, backend="hopper")          # dense (I, J, K)

``estimate`` accepts cost descriptors (``MTTKRPWorkload`` /
``SparseMTTKRPWorkload`` / ``MatmulWorkload``) *or* raw data (dense tensor,
COO triple, sparse container — summarized via ``backends.describe``);
``execute`` accepts an :class:`MTTKRPProblem` or raw data plus ``factors=``.
All take ``backend=`` as a registry name (or a prebuilt
:class:`~repro_torch.backends.Backend`) and ``config=`` as one
``PsramConfig`` (default: the paper's §V-A operating point, validated at
backend construction). Results live on the device of the tensors handed in.
This module is deliberately thin — every behavior lives in
``repro_torch.backends``.

The defaults are the reference's: ``estimate`` prices on ``"analytical"``,
``execute`` and ``mttkrp`` run ``"psram-stream"``, ``matmul`` runs
``"psram-scheduled"`` (the §IV dense array mapping).
"""
from __future__ import annotations

from repro_torch import backends
from repro_torch.backends import Estimate, MatmulWorkload, MTTKRPProblem

__all__ = [
    "Estimate",
    "MTTKRPProblem",
    "MatmulWorkload",
    "estimate",
    "execute",
    "matmul",
    "mttkrp",
]


def estimate(workload, backend: str = "analytical", config=None,
             rank: int | None = None, mode: int = 0) -> Estimate:
    """Price ``workload`` on ``backend`` without running it.

    ``workload`` is any member of the Workload union; raw data needs
    ``rank=`` (and ``mode=`` for sparse) to derive the cost descriptor.
    Returns an :class:`~repro_torch.backends.Estimate` (utilization
    breakdown, time, counted cycles + energy when the backend prices a
    schedule).
    """
    be = backends.get(backend, config)
    return be.cost(backends.describe(workload, rank=rank, mode=mode))


def execute(workload, backend: str = "psram-stream", config=None, *,
            factors=None, mode: int = 0):
    """Run an MTTKRP workload on ``backend`` and return the ``(I_mode, R)``
    result.

    ``workload`` is an :class:`MTTKRPProblem`, or raw data (dense tensor /
    COO triple / sparse container) with ``factors=`` supplied alongside.
    """
    if isinstance(workload, MTTKRPProblem):
        if factors is not None:
            raise ValueError("MTTKRPProblem already carries factors")
        data, factors, mode = workload.data, workload.factors, workload.mode
    else:
        if factors is None:
            raise ValueError(
                "pass factors= (or wrap the data in api.MTTKRPProblem)")
        data = workload
    return mttkrp(data, factors, mode, backend=backend, config=config)


def mttkrp(data, factors, mode: int = 0, backend: str = "psram-stream",
           config=None):
    """MTTKRP of ``data`` against ``factors`` along ``mode`` on ``backend``."""
    return backends.get(backend, config).mttkrp(data, tuple(factors), mode)


def matmul(x, w, backend: str = "psram-scheduled", config=None):
    """``x @ w`` on ``backend`` (the §IV dense array mapping by default)."""
    return backends.get(backend, config).matmul(x, w)
