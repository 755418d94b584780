"""repro_torch.core — numerics of the pSRAM engine and the CP-ALS loop.

Ported: ``quantization`` (whole), ``psram`` (``PsramConfig`` only),
``mttkrp`` (exact dense + sparse paths, the quantized sparse chain),
``cp_als`` (with ``cp_als_psram``), ``photonic_layer`` (all but the
MoE-only ``psram_einsum``). Still to come from the reference package:
``psram.PsramArray``, ``schedule``, ``perf_model``, ``scaling``,
``primitives``.
"""
