"""repro_torch.api — the execute facade over the backend registry.

>>> from repro_torch import api
>>> out = api.execute(api.MTTKRPProblem(coo, factors, mode=0))   # "psram-stream"
>>> y   = api.matmul(x, w, backend="hopper")
>>> a   = api.mttkrp(x3, factors, mode=1, backend="hopper")   # dense (I, J, K)

``execute`` accepts an :class:`MTTKRPProblem` or raw data plus ``factors=``.
All take ``backend=`` as a registry name (or a prebuilt
:class:`~repro_torch.backends.Backend`) and ``config=`` as one
``PsramConfig`` (default: the paper's §V-A operating point). Data may be a
dense 3-mode tensor (the quantized dense KR kernel on ``"hopper"``), a COO
triple or a sparse container. Results live on the device of the tensors
handed in. This module is deliberately thin —
every behavior lives in ``repro_torch.backends``.

``execute`` and ``mttkrp`` default to ``"psram-stream"``, as the reference's
do: the streaming schedule with the quantized chain. ``matmul`` defaults to
``"hopper"`` until the reference's default, ``"psram-scheduled"``, comes with
the array's tile schedules, and ``estimate`` waits for the cost side
(``core.perf_model``) — both ROADMAP Queue A item 3.
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


def matmul(x, w, backend: str = "hopper", config=None):
    """``x @ w`` on ``backend``."""
    return backends.get(backend, config).matmul(x, w)
