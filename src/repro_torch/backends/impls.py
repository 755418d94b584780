"""First-class backends of the port.

=================  =========================================================
name               wraps
=================  =========================================================
``exact``          float einsum / COO scatter-add — the parity baseline
``psram-oracle``   the flat quantized CP chain (sparse MTTKRP,
                   ``mttkrp_sparse_psram``); its matmul (the per-cycle
                   array interpreter) waits for ROADMAP Queue A item 3
``psram-stream``   the nonzero-streaming sparse schedule
                   (``repro_torch.sparse.stream``): quantized chain, eager
                   per-nonzero fold or (``compiled=True``) the
                   blocked-segment fold; its cost model waits for item 3
``hopper``         the hand-written CUDA kernel family (plain PyTorch
                   versions for CPU tensors): pSRAM int8 matmul, quantized
                   dense KR MTTKRP, fused streaming sparse MTTKRP; with
                   ``compiled=False`` the legacy per-op path (exact dense
                   KR MTTKRP, blocked segment-sum stream) — the reference
                   package's ``"pallas"`` backend
=================  =========================================================

Numeric contracts the parity suites (tests/test_torch_cp_als.py,
tests/test_torch_psram_stream.py) enforce: every lossy backend lands within
its documented ``rel_tol`` of ``exact``; ``psram-stream`` equals
``mttkrp_sparse_psram`` on the sorted stream, bit for bit.
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


_PRICING = "the array's cost model and tile schedules (ROADMAP Queue A item 3)"


@register("psram-oracle")
class PsramOracleBackend(Backend):
    """The array numerics op by op: the flat quantized CP chain
    (``mttkrp_sparse_psram``: every CP1/CP2 product through 8-bit operands
    and the ADC, CP3 exact adds in stream order) on the COO triple of any
    data form. The reference's per-cycle ``PsramArray`` matmul and its
    schedule pricing come with ROADMAP Queue A item 3: until then
    ``matmul`` and ``cost`` raise :class:`CapabilityError` and the
    capabilities say ``matmul=False, cost_model=False``."""

    def capabilities(self) -> Capabilities:
        return Capabilities(
            executes=True, cost_model=False, matmul=False, lossy=True, rel_tol=0.05,
            description="quantized chain (flat; the per-cycle array matmul waits for "
                        "item 3)",
        )

    def matmul(self, x, w):
        raise CapabilityError(f"backend 'psram-oracle' runs matmuls on the per-cycle array "
                              f"interpreter, which comes with {_PRICING}")

    def mttkrp(self, data, factors, mode: int):
        from repro_torch.core.mttkrp import mttkrp_sparse_psram

        idx, vals, shape = to_coo_triple(normalize_mttkrp_data(data))
        return mttkrp_sparse_psram(idx, vals, tuple(factors), mode, shape[mode],
                                   adc_bits=self.config.adc.bits)

    def cost(self, workload):
        raise CapabilityError(f"backend 'psram-oracle' prices schedules, which come with "
                              f"{_PRICING}")


@register("psram-stream")
class PsramStreamBackend(Backend):
    """The nonzero-streaming sparse schedule (``repro_torch.sparse.stream``):
    blocks of quantized CP2 chain rows stored down the word-lines,
    per-output-row gather masks driven per WDM channel, electrical
    cross-block carry. Dense data is accepted by COO-ifying (all entries
    stream as nonzeros). On the card the quantized chain is formed inside
    the kernels: the eager fold is one launch of the ordered fold's chain
    route, bit-for-bit ``mttkrp_sparse_psram`` on the sorted stream.

    ``compiled=True`` opts into the blocked-segment fold (kernel 5's chain
    route, then the ordered fold's fold route on its partials): a
    reassociated fold against the eager one — ``bit_exact`` drops, the
    quantization envelope (``rel_tol``) is unchanged.

    The reference prices fiber-length distributions here; that cost model
    comes with ROADMAP Queue A item 3, so until then ``cost`` raises
    :class:`CapabilityError` and the capabilities say ``cost_model=False``."""

    def __init__(self, config=None, compiled: bool = False):
        super().__init__(config)
        self.compiled = bool(compiled)

    def capabilities(self) -> Capabilities:
        return Capabilities(
            executes=True, cost_model=False, matmul=False, lossy=True,
            rel_tol=0.05, prefers_csf=True,
            bit_exact=not self.compiled, compiled=self.compiled,
            description="nonzero-streaming sparse schedule (quantized chain)"
                        + (" [compiled]" if self.compiled else ""),
        )

    def mttkrp(self, data, factors, mode: int):
        from repro_torch.sparse.stream import stream_mttkrp

        csf = mode_csf(normalize_mttkrp_data(data), mode)
        return stream_mttkrp(csf, tuple(factors), self.config, psram=True,
                             adc_bits=self.config.adc.bits, compiled=self.compiled)

    def cost(self, workload):
        raise CapabilityError(f"backend 'psram-stream' prices fiber-length distributions "
                              f"with {_PRICING}")


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
