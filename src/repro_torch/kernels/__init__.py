"""repro_torch.kernels — the hand-written Hopper kernels and their wrappers.

``csrc/*.cu`` are CUDA C++ sources built at first use by ``_build`` (nvcc,
``sm_90a``, plain C interface, ``ctypes``). Beside each kernel, in the same
module: a plain PyTorch version, a launch counter on the wrapper, and a note
on which TPU kernel it replaces and what bounds it on the card.

Ported: the pSRAM int8 matmul (``psram_matmul``: a tile route and a
decode-row route), the fused streaming MTTKRP (``stream_mttkrp``), the dense
MTTKRP pair, exact and quantized (``mttkrp``), the blocked segment sum
(``segment_sum``) and flash attention (``flash_attention``) — every Pallas
kernel of the reference package — plus the port's own ordered fold
(``ordered_fold``), which keeps the exact sparse MTTKRP's scatter in stream
order on the card; and ``autotune``, the chunk-size sweeps of the fused
stream kernel with their winner cache (``save_cache`` / ``load_cache``,
whose tables the reference package reads and writes alike).
"""
from .autotune import TuneKey, clear_autotune_cache, load_cache, save_cache

__all__ = ["TuneKey", "clear_autotune_cache", "load_cache", "save_cache"]
