"""First-class backends of the port.

=================  =========================================================
name               wraps
=================  =========================================================
``exact``          float einsum / COO scatter-add — the parity baseline
``hopper``         the hand-written CUDA kernel family (plain PyTorch
                   versions for CPU tensors): pSRAM int8 matmul, quantized
                   dense KR MTTKRP, fused streaming sparse MTTKRP; with
                   ``compiled=False`` the legacy per-op path (exact dense
                   KR MTTKRP, blocked segment-sum stream) — the reference
                   package's ``"pallas"`` backend
=================  =========================================================

Numeric contract the parity suite (tests/test_torch_cp_als.py) enforces:
the lossy backend lands within its documented ``rel_tol`` of ``exact``.
"""
from __future__ import annotations

import torch

from repro_torch._device import ieee_f32

from .base import Backend, Capabilities, CapabilityError, register
from .lowering import validate_lowering
from .workload import mode_csf, normalize_mttkrp_data, to_coo_triple


@register("exact")
class ExactBackend(Backend):
    """Float reference numerics — the baseline every backend is compared to.
    Its products run in IEEE f32 whatever TF32 setting the caller chose
    (:func:`repro_torch._device.ieee_f32`)."""

    def capabilities(self) -> Capabilities:
        return Capabilities(
            executes=True, cost_model=False, matmul=True,
            description="exact float einsum / COO scatter-add",
        )

    @ieee_f32()
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
    matmul, the quantized dense matricized-KR MTTKRP and the fused streaming
    sparse MTTKRP (int8 factor gathers + exact Hadamard + per-segment sums +
    chunk-wide ADC + ordered cross-block accumulation).

    ``compiled=False`` selects the legacy per-op path of the reference's
    ``"pallas"`` backend: the exact dense MTTKRP kernel on dense data, and on
    sparse data the exact chain through the blocked segment-sum kernel
    (``sparse.stream.stream_mttkrp_blocked``).

    ``lowering`` is ``"auto"`` (follow the device of the tensors: CUDA →
    the kernels, CPU → their plain PyTorch versions), or a resolved name
    (``"cuda"`` / ``"torch"`` / ``"ref"``). The string is validated at
    construction and resolved per call, because ``"auto"`` depends on the
    tensors handed in. The fused path reassociates float adds against its
    oracle (``bit_exact=False``) and stays within the documented ADC
    envelope (``rel_tol=0.05``) of ``exact``.

    ``autotune=True`` raises :class:`CapabilityError` until the autotune
    sweeps are ported.
    """

    def __init__(self, config=None, lowering: str = "auto",
                 compiled: bool = True, autotune: bool = False):
        super().__init__(config)
        self.compiled = bool(compiled)
        self.autotune = bool(autotune)
        self.lowering = validate_lowering(lowering)
        if self.autotune:
            raise CapabilityError(
                "backend 'hopper' with autotune=True needs the autotune "
                "sweeps, which are not ported yet (ROADMAP Queue A item 2)")

    def capabilities(self) -> Capabilities:
        return Capabilities(
            executes=True, cost_model=False, matmul=True, lossy=True,
            bit_exact=False, rel_tol=0.05, prefers_csf=True,
            compiled=self.compiled, autotune=self.autotune,
            description="fused Hopper kernel family (int8 matmul, quantized "
                        "KR dense, fused streaming sparse)"
                        + ("" if self.compiled else " [legacy per-op]"),
        )

    def matmul(self, x, w):
        from repro_torch.kernels.ops import psram_matmul_op

        return psram_matmul_op(
            x, w, adc_bits=self.config.adc.bits, lowering=self.lowering)

    def mttkrp(self, data, factors, mode: int):
        norm = normalize_mttkrp_data(data)
        if norm.kind == "dense":
            from repro_torch.kernels.ops import mttkrp_op, mttkrp_psram_op

            self._require("N-mode dense MTTKRP (3-mode kernel)",
                          norm.dense.ndim == 3)
            others = [d for d in range(3) if d != mode]
            xt = norm.dense.permute([mode] + others)
            op = mttkrp_psram_op if self.compiled else mttkrp_op
            # as in the reference, the dense ops run at their defaults
            # (adc_bits=16, bi=bk=128) whatever the config says, so that the
            # two packages give the same numbers
            return op(xt, factors[others[0]], factors[others[1]],
                      lowering=self.lowering)
        csf = mode_csf(norm, mode)
        if self.compiled:
            from repro_torch.kernels.ops import fused_stream_mttkrp_op

            return fused_stream_mttkrp_op(
                csf, tuple(factors), self.config,
                adc_bits=self.config.adc.bits, lowering=self.lowering,
                autotune=self.autotune)
        from repro_torch.sparse.stream import stream_mttkrp_blocked

        return stream_mttkrp_blocked(
            csf, tuple(factors), self.config, lowering=self.lowering)
