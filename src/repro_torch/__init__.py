"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

Same sub-package names as the JAX package so every counterpart is found at
the same relative path. The port imports ``torch`` and ``numpy`` only —
never ``jax`` and nothing from ``repro``. Entry points that create tensors
take an explicit ``device`` (default ``"cuda"``); asking for the card on a
box without one raises rather than carrying on on the CPU.

Ported so far: the sparse CP-ALS main path — ``core.quantization``,
``core.mttkrp``, ``core.cp_als``, ``sparse.formats`` / ``synth`` /
``stream`` — the array model and its price (``core.psram``,
``core.schedule``, ``core.perf_model``, ``core.scaling``,
``core.primitives``, the planners of ``sparse.partition``), the backend
registry with the ``"exact"``, ``"psram-oracle"``, ``"psram-scheduled"``,
``"psram-stream"`` (the quantized chain, eager and compiled), ``"hopper"``
(dense data and ``compiled=False`` included) and ``"analytical"``
backends, ``api`` (estimate / execute / mttkrp / matmul), the dense decoder family (``models``, ``configs``,
``core.photonic_layer``), ``serve`` (``ServeEngine``, the offload reports
and the paged serve loop) and ``launch.serve``, training (``optim``,
``dist.compression``, ``train``, ``checkpoint``, ``data`` and
``launch.train``), on one device or one process a card over a model mesh
(``dist.placement``: DTensors over a ``DeviceMesh``),
``obs`` (the tracer with device-true spans and stopwatch, the instrumented
backends, the schedule-IR timelines and the drift auditor), and
six hand-written CUDA kernels (``kernels/csrc``), one for every Pallas
kernel of the reference: the fused streaming MTTKRP, the pSRAM int8 matmul,
the dense MTTKRP pair, the blocked segment sum and flash attention.
"""
from ._device import as_device

__all__ = ["as_device"]
