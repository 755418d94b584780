"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

Same sub-package names as the JAX package so every counterpart is found at
the same relative path. The port imports ``torch`` and ``numpy`` only —
never ``jax`` and nothing from ``repro``. Entry points that create tensors
take an explicit ``device`` (default ``"cuda"``); asking for the card on a
box without one raises rather than carrying on on the CPU.

Ported so far: the sparse CP-ALS main path — ``core.quantization``,
``core.mttkrp``, ``core.cp_als``, ``sparse.formats`` / ``synth`` /
``stream`` (layout + exact eager executor), the backend registry with the
``"exact"`` and ``"hopper"`` backends, ``api`` (execute / mttkrp / matmul),
and two hand-written CUDA kernels (``kernels/csrc``): the fused streaming
MTTKRP and the pSRAM int8 matmul.
"""
from ._device import as_device

__all__ = ["as_device"]
