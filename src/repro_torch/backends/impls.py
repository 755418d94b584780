"""First-class backends of the port.

=================  =========================================================
name               wraps
=================  =========================================================
``exact``          float einsum / COO scatter-add — the parity baseline
``hopper``         the hand-written CUDA kernel family (plain PyTorch
                   versions for CPU tensors): pSRAM int8 matmul, fused
                   streaming sparse MTTKRP — the reference package's
                   ``"pallas"`` backend
=================  =========================================================

Numeric contract the parity suite (tests/test_torch_cp_als.py) enforces:
the lossy backend lands within its documented ``rel_tol`` of ``exact``.
"""
from __future__ import annotations

import torch

from .base import Backend, Capabilities, CapabilityError, register
from .lowering import validate_lowering
from .workload import mode_csf, normalize_mttkrp_data, to_coo_triple


@register("exact")
class ExactBackend(Backend):
    """Float reference numerics — the baseline every backend is compared to."""

    def capabilities(self) -> Capabilities:
        return Capabilities(
            executes=True, cost_model=False, matmul=True,
            description="exact float einsum / COO scatter-add",
        )

    def matmul(self, x, w):
        return x.to(torch.float32) @ w.to(torch.float32)

    def mttkrp(self, data, factors, mode: int):
        from repro_torch.core.mttkrp import mttkrp_dense, mttkrp_sparse

        norm = normalize_mttkrp_data(data)
        if norm.kind == "dense":
            return mttkrp_dense(norm.dense, list(factors), mode)
        idx, vals, shape = to_coo_triple(norm)
        return mttkrp_sparse(idx, vals, tuple(factors), mode, shape[mode])


@register("hopper")
class HopperBackend(Backend):
    """The fused kernel family written by hand for Hopper: the pSRAM int8
    matmul and the fused streaming sparse MTTKRP (int8 factor gathers +
    exact Hadamard + per-segment sums + chunk-wide ADC + ordered
    cross-block accumulation).

    ``lowering`` is ``"auto"`` (follow the device of the tensors: CUDA →
    the kernels, CPU → their plain PyTorch versions), or a resolved name
    (``"cuda"`` / ``"torch"`` / ``"ref"``). The string is validated at
    construction and resolved per call, because ``"auto"`` depends on the
    tensors handed in. The fused path reassociates float adds against its
    oracle (``bit_exact=False``) and stays within the documented ADC
    envelope (``rel_tol=0.05``) of ``exact``.

    Only the default ``compiled=True`` family on sparse data is ported.
    ``compiled=False`` (the per-op path: exact dense kernel, blocked
    segment-sum stream), dense data and ``autotune=True`` raise
    :class:`CapabilityError` naming what brings them.
    """

    def __init__(self, config=None, lowering: str = "auto",
                 compiled: bool = True, autotune: bool = False):
        super().__init__(config)
        self.compiled = bool(compiled)
        self.autotune = bool(autotune)
        self.lowering = validate_lowering(lowering)
        if not self.compiled:
            raise CapabilityError(
                "backend 'hopper' with compiled=False needs the dense MTTKRP "
                "and blocked segment-sum kernels, which are not ported yet "
                "(ROADMAP Queue A item 1: mttkrp_fused, blocked_segment_sum)")
        if self.autotune:
            raise CapabilityError(
                "backend 'hopper' with autotune=True needs the autotune "
                "sweeps, which are not ported yet (ROADMAP Queue A item 2)")

    def capabilities(self) -> Capabilities:
        return Capabilities(
            executes=True, cost_model=False, matmul=True, lossy=True,
            bit_exact=False, rel_tol=0.05, prefers_csf=True,
            compiled=self.compiled, autotune=self.autotune,
            description="fused Hopper kernel family (int8 matmul, fused "
                        "streaming sparse MTTKRP)",
        )

    def matmul(self, x, w):
        from repro_torch.kernels.ops import psram_matmul_op

        return psram_matmul_op(
            x, w, adc_bits=self.config.adc.bits, lowering=self.lowering)

    def mttkrp(self, data, factors, mode: int):
        norm = normalize_mttkrp_data(data)
        if norm.kind == "dense":
            raise CapabilityError(
                "backend 'hopper' on a dense tensor needs the quantized "
                "dense MTTKRP kernel, which is not ported yet (ROADMAP "
                "Queue A item 1: mttkrp_psram_fused); CP-ALS streams dense "
                "input as all-entries COO instead")
        from repro_torch.kernels.ops import fused_stream_mttkrp_op

        return fused_stream_mttkrp_op(
            mode_csf(norm, mode), tuple(factors), self.config,
            adc_bits=self.config.adc.bits, lowering=self.lowering,
            autotune=self.autotune)
