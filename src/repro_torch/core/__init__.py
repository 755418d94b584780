"""repro_torch.core — the paper's contribution: the pSRAM array model, the
tile-schedule IR every photonic path lowers through, CP1-3 primitives,
MTTKRP, CP-ALS, the predictive performance model, and the photonic-offload
projection layer.

Ported: ``quantization``, ``psram`` (``PsramConfig``, ``PsramArray``,
``matmul_via_array``), ``schedule`` (the IR, the program cache, the
accountant, the per-cycle oracle and the vectorized executor, with the
reference's ``obs`` spans and ``faults`` hooks),
``perf_model`` (the §V closed forms, the mesh price and the energy model;
an H100 roofline in place of the reference's TPU one), ``scaling``,
``primitives``, ``mttkrp`` (exact dense + sparse paths, the quantized sparse
chain), ``cp_als`` (with ``cp_als_psram``) and ``photonic_layer`` (its MoE-only
``psram_einsum`` too, not re-exported here, as in the reference).

The reference's exports that exist in the port are re-exported here, but for
the function ``cp_als``: on this package the name ``cp_als`` stays the
module (``from repro_torch.core import cp_als`` gives the module, as the
port's callers and tests import it); the function is
``repro_torch.core.cp_als.cp_als``.
"""
from .cp_als import CPState, cp_als_psram, init_factors, reconstruct
from .mttkrp import (
    dense_to_coo,
    khatri_rao,
    matricize,
    mttkrp_dense,
    mttkrp_dense_kr,
    mttkrp_sparse,
    mttkrp_sparse_psram,
    mttkrp_sparse_psram_scheduled,
)
from .perf_model import (
    EnergyBreakdown,
    EnergySpec,
    MTTKRPWorkload,
    SustainedBreakdown,
    h100_mttkrp_time_s,
    measured_utilization,
    peak_ops,
    peak_petaops,
    sustained_mttkrp,
    sweep_channels,
    sweep_frequency,
    time_to_solution_s,
)
from .photonic_layer import maybe_psram_matmul, program_weights, psram_linear
from .psram import PsramArray, PsramConfig, matmul_via_array
from .quantization import (
    ADCConfig,
    QMAX,
    WORD_BITS,
    adc_requantize,
    adc_transfer,
    dequantize,
    fake_quant,
    from_bitplanes,
    psram_quantized_matmul,
    quantize_symmetric,
    to_bitplanes,
)
from .scaling import FabricSpec, ScalingPoint, knee, scale, sweep
from .schedule import (
    CycleCounts,
    Drive,
    StoreTile,
    TileProgram,
    build_matmul_program,
    build_mttkrp_program,
    count_cycles,
    execute,
    execute_reference,
    program_energy,
)

__all__ = [k for k in dir() if not k.startswith("_")]
