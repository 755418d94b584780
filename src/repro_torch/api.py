"""repro_torch.api — the execute facade over the backend registry.

>>> from repro_torch import api
>>> out = api.execute(api.MTTKRPProblem(coo, factors, mode=0), backend="hopper")
>>> y   = api.matmul(x, w, backend="hopper")

``execute`` accepts an :class:`MTTKRPProblem` or raw data plus ``factors=``.
All take ``backend=`` as a registry name (or a prebuilt
:class:`~repro_torch.backends.Backend`) and ``config=`` as one
``PsramConfig`` (default: the paper's §V-A operating point). Results live on
the device of the tensors handed in. This module is deliberately thin —
every behavior lives in ``repro_torch.backends``.

``estimate`` of the reference facade waits for the cost side
(``core.perf_model``); the default backend here is ``"hopper"`` until the
reference's defaults (``"psram-stream"`` / ``"psram-scheduled"``) are ported.
"""
from __future__ import annotations

from repro_torch import backends
from repro_torch.backends import MatmulWorkload, MTTKRPProblem

__all__ = [
    "MTTKRPProblem",
    "MatmulWorkload",
    "execute",
    "matmul",
    "mttkrp",
]


def execute(workload, backend: str = "hopper", config=None, *,
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


def mttkrp(data, factors, mode: int = 0, backend: str = "hopper",
           config=None):
    """MTTKRP of ``data`` against ``factors`` along ``mode`` on ``backend``."""
    return backends.get(backend, config).mttkrp(data, tuple(factors), mode)


def matmul(x, w, backend: str = "hopper", config=None):
    """``x @ w`` on ``backend``."""
    return backends.get(backend, config).matmul(x, w)
