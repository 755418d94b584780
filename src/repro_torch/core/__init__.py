"""repro_torch.core — numerics of the pSRAM engine and the CP-ALS loop.

Ported: ``quantization`` (whole), ``psram`` (``PsramConfig`` only),
``mttkrp`` (exact dense + sparse paths), ``cp_als``. Still to come from the
reference package: ``psram.PsramArray``, ``schedule``, ``perf_model``,
``scaling``, ``primitives``, ``photonic_layer``.
"""
