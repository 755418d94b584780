"""First-class backends of the port.

=================  =========================================================
name               wraps
=================  =========================================================
``exact``          float einsum / COO scatter-add — the parity baseline
``psram-oracle``   per-cycle :class:`PsramArray` physics (matmul:
                   ``schedule.execute_reference``) and the flat quantized CP
                   chain (sparse MTTKRP, ``mttkrp_sparse_psram``) — slow,
                   faithful; counted-cycle cost model
``psram-scheduled``the tile-schedule IR: vectorized executor for matmuls
                   and the §IV dense mapping (matricized MTTKRP as an array
                   matmul), ``compiled=True`` a CUDA graph replay on the
                   card; counted-cycle cost model
``psram-stream``   the nonzero-streaming sparse schedule
                   (``repro_torch.sparse.stream``): quantized chain, eager
                   per-nonzero fold or (``compiled=True``) the
                   blocked-segment fold; fiber-distribution cost model
``hopper``         the hand-written CUDA kernel family (plain PyTorch
                   versions for CPU tensors): pSRAM int8 matmul, quantized
                   dense KR MTTKRP, fused streaming sparse MTTKRP; with
                   ``compiled=False`` the legacy per-op path (exact dense
                   KR MTTKRP, blocked segment-sum stream) — the reference
                   package's ``"pallas"`` backend
``psram-mesh``     many arrays: the streaming schedule over an array mesh
                   (``repro_torch.sparse.mesh``) — planned shards, one
                   launch each, partials added by the reduction fabric
``analytical``     the closed-form §V model (with its mesh price) —
                   cost-only, never executes
=================  =========================================================

Numeric contracts the parity suites (tests/test_torch_cp_als.py,
tests/test_torch_psram_stream.py, tests/test_torch_perf_model.py) enforce:
``psram-oracle`` and ``psram-scheduled`` matmuls are *bit-identical*;
``psram-stream`` equals ``mttkrp_sparse_psram`` on the sorted stream, bit for
bit; every lossy backend lands within its documented ``rel_tol`` of
``exact``; ``analytical``'s §V-A dense breakdown equals
``psram-scheduled``'s counted cycles exactly; every price equals the
reference's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import ieee_f32

from .base import Backend, Capabilities, CapabilityError, Estimate, register
from .lowering import validate_lowering
from .workload import (
    MatmulWorkload,
    describe,
    mode_csf,
    normalize_mttkrp_data,
    to_coo_triple,
)


def _program_estimate(name, cfg, program, workload) -> Estimate:
    """Estimate from a schedule (the counted-cycle pricing every scheduled
    backend shares)."""
    from repro_torch.core.perf_model import breakdown_from_counts
    from repro_torch.core.schedule import count_cycles, program_energy

    counts = count_cycles(program)
    return Estimate(
        backend=name,
        config=cfg,
        workload=workload,
        breakdown=breakdown_from_counts(cfg, counts),
        time_s=counts.duration_s(cfg),
        counts=counts,
        energy=program_energy(program),
    )


def _matmul_program(cfg, wl: MatmulWorkload):
    from repro_torch.core.schedule import build_matmul_program

    prog = build_matmul_program(wl.m, wl.k, wl.n, cfg)
    if wl.repeats != 1:
        prog = dataclasses.replace(prog, repeats=wl.repeats)
    return prog


class _SchedulePricing:
    """cost() shared by the two dense schedule backends: the canonical §IV/§V
    programs, counted."""

    def cost(self, workload) -> Estimate:
        from repro_torch.core.perf_model import MTTKRPWorkload
        from repro_torch.core.schedule import build_mttkrp_program

        workload = describe(workload)
        if isinstance(workload, MatmulWorkload):
            return _program_estimate(
                self.name, self.config, _matmul_program(self.config, workload),
                workload)
        if isinstance(workload, MTTKRPWorkload):
            return _program_estimate(
                self.name, self.config,
                build_mttkrp_program(self.config, workload), workload)
        raise CapabilityError(
            f"backend {self.name!r} prices dense schedules; use "
            "'psram-stream' or 'analytical' for sparse workloads"
        )


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


@register("psram-oracle")
class PsramOracleBackend(Backend):
    """The array physics, op by op: ``execute_reference`` for matmuls, the
    flat quantized CP chain (``mttkrp_sparse_psram``: every CP1/CP2 product
    through 8-bit operands and the ADC, CP3 exact adds in stream order) for
    MTTKRP on the COO triple of any data form — the slowest and most
    transparently faithful substrate."""

    def capabilities(self) -> Capabilities:
        return Capabilities(
            executes=True, cost_model=True, matmul=True, lossy=True,
            rel_tol=0.05, prices=("dense", "matmul"),
            description="per-cycle PsramArray interpreter / quantized chain",
        )

    def matmul(self, x, w):
        from repro_torch.core.schedule import build_matmul_program, execute_reference

        m, k = x.shape
        n = w.shape[1]
        return execute_reference(build_matmul_program(m, k, n, self.config), x, w)

    def mttkrp(self, data, factors, mode: int):
        from repro_torch.core.mttkrp import mttkrp_sparse_psram

        idx, vals, shape = to_coo_triple(normalize_mttkrp_data(data))
        return mttkrp_sparse_psram(idx, vals, tuple(factors), mode, shape[mode],
                                   adc_bits=self.config.adc.bits)

    cost = _SchedulePricing.cost


@register("psram-scheduled")
class PsramScheduledBackend(Backend):
    """The tile-schedule IR's vectorized executor (§IV dense mapping).

    MTTKRP runs as the matricized matmul ``X_(n) @ KhatriRao(others)``
    through the array — weights stationary, inputs WDM-batched — which is
    bit-identical to the per-cycle oracle on the same program and lands
    within the ADC envelope of ``exact``. The executor runs on the tensors'
    device: batched contractions in plain PyTorch (no hand-written kernel;
    the reference computes it outside any Pallas kernel too).

    ``compiled=True`` opts into the cached compiled executor
    (``schedule.compiled_matmul_executor``): on the card the eager executor
    captured once in a CUDA graph and replayed. ``bit_exact`` drops and the
    ~1e-7 envelope against the eager oracle is the documented contract, as
    in the reference.
    """

    def __init__(self, config=None, compiled: bool = False):
        super().__init__(config)
        self.compiled = bool(compiled)

    def capabilities(self) -> Capabilities:
        return Capabilities(
            executes=True, cost_model=True, matmul=True, sparse=False,
            lossy=True, rel_tol=0.05, prices=("dense", "matmul"),
            bit_exact=not self.compiled, compiled=self.compiled,
            description="vectorized tile-schedule executor (dense mapping)"
                        + (" [compiled]" if self.compiled else ""),
        )

    def matmul(self, x, w):
        from repro_torch.core.schedule import build_matmul_program, execute

        m, k = x.shape
        n = w.shape[1]
        return execute(build_matmul_program(m, k, n, self.config), x, w,
                       compiled=self.compiled)

    def mttkrp(self, data, factors, mode: int):
        from repro_torch.core.mttkrp import khatri_rao, matricize

        norm = normalize_mttkrp_data(data)
        self._require("sparse MTTKRP (use 'psram-stream')",
                      norm.kind == "dense")
        others = [factors[d] for d in range(norm.dense.ndim) if d != mode]
        return self.matmul(matricize(norm.dense, mode), khatri_rao(others))

    cost = _SchedulePricing.cost


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

    ``cost`` prices a fiber-length distribution by counting the streaming
    schedule (``sparse.stream.build_stream_program``)."""

    def __init__(self, config=None, compiled: bool = False):
        super().__init__(config)
        self.compiled = bool(compiled)

    def capabilities(self) -> Capabilities:
        return Capabilities(
            executes=True, cost_model=True, matmul=False, lossy=True,
            rel_tol=0.05, prices=("sparse",), prefers_csf=True,
            bit_exact=not self.compiled, compiled=self.compiled,
            description="nonzero-streaming sparse schedule (quantized chain)"
                        + (" [compiled]" if self.compiled else ""),
        )

    def mttkrp(self, data, factors, mode: int):
        from repro_torch.sparse.stream import stream_mttkrp

        csf = mode_csf(normalize_mttkrp_data(data), mode)
        return stream_mttkrp(csf, tuple(factors), self.config, psram=True,
                             adc_bits=self.config.adc.bits, compiled=self.compiled)

    def cost(self, workload) -> Estimate:
        from repro_torch.core.perf_model import SparseMTTKRPWorkload
        from repro_torch.sparse.stream import build_stream_program

        workload = describe(workload)
        if not isinstance(workload, SparseMTTKRPWorkload):
            raise CapabilityError(
                "backend 'psram-stream' prices fiber-length distributions "
                "(SparseMTTKRPWorkload); use 'psram-scheduled' or "
                "'analytical' for dense descriptors"
            )
        prog = build_stream_program(
            workload.fiber_lengths, workload.rank, self.config)
        return _program_estimate(self.name, self.config, prog, workload)


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

    ``autotune=True`` takes the fused sparse path's chunk size
    (``exec_blocks``) from ``kernels.autotune``'s winner cache, sweeping the
    candidates on the real operands on a miss (``caps.autotune``). The chunk
    size is numerics (each chunk's ADC range): a tuned run stays within the
    same envelope of ``exact``, and is bit-equal to an untuned call at the
    winner's ``exec_blocks``.
    """

    def __init__(self, config=None, lowering: str = "auto",
                 compiled: bool = True, autotune: bool = False):
        super().__init__(config)
        self.compiled = bool(compiled)
        self.autotune = bool(autotune)
        self.lowering = validate_lowering(lowering)

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


@register("psram-mesh")
class PsramMeshBackend(Backend):
    """The streaming sparse schedule scaled past one array: shards from the
    partition planner land on the arrays of an ``ArrayMesh``, every array
    drains its shard (in turn on one card; round-robin over several), and
    the reduction fabric adds the partial factor outputs
    (``repro_torch.sparse.mesh``). Dense data is accepted by COO-ifying.

    ``n_arrays=None`` makes one array per visible device of the data's type
    (1 on the CPU, the mesh then degenerating to exactly the single-device
    schedule). The planner never splits a root fiber, so the default eager
    lowering is *bit-identical* to ``"psram-stream"`` and independent of the
    array count and order; ``compiled=True`` runs the blocked-segment fold
    per shard (reassociated, ``bit_exact`` drops); ``lowering="fused"`` runs
    the int8 fused chunk kernel per shard. ``gram`` adds the row shards'
    partial Grams; ``cost()`` prices the planned split — per-array counted
    makespan plus the fabric all-reduce — with the same closed forms
    ``"analytical"`` uses, so estimate==measured stays exact at mesh scale.
    """

    def __init__(self, config=None, n_arrays: int | None = None,
                 compiled: bool = False, lowering: str | None = None,
                 planner: str = "makespan", fabric=None):
        super().__init__(config)
        from repro_torch.sparse.mesh import MESH_LOWERINGS

        self.n_arrays = None if n_arrays is None else int(n_arrays)
        self.lowering = lowering or ("compiled" if compiled else "eager")
        if self.lowering not in MESH_LOWERINGS:
            raise ValueError(
                f"unknown mesh lowering {self.lowering!r}; pick one of "
                f"{MESH_LOWERINGS}")
        self.compiled = self.lowering != "eager"
        self.planner = planner
        self.fabric = fabric

    def capabilities(self) -> Capabilities:
        return Capabilities(
            executes=True, cost_model=True, matmul=False, lossy=True,
            rel_tol=0.05, prices=("sparse",), prefers_csf=True,
            bit_exact=not self.compiled, compiled=self.compiled,
            description="mesh-sharded streaming schedule (a launch per "
                        f"shard + reduction fabric, {self.lowering} fold)",
        )

    def mttkrp(self, data, factors, mode: int):
        from repro_torch.sparse.mesh import mesh_stream_mttkrp

        csf = mode_csf(normalize_mttkrp_data(data), mode)
        return mesh_stream_mttkrp(
            csf, tuple(factors), self.config, n_arrays=self.n_arrays,
            psram=True, adc_bits=self.config.adc.bits,
            lowering=self.lowering, planner=self.planner,
        )

    def gram(self, f):
        """The Gram of the row shards' partial ``(R, R)`` Grams added in
        array order (``sparse.mesh.mesh_gram``; one array: ``f.T @ f``)."""
        from repro_torch.sparse.mesh import mesh_gram

        return mesh_gram(f, n_arrays=self.n_arrays)

    def cost(self, workload) -> Estimate:
        from repro_torch.core.perf_model import (
            MeshSparseMTTKRPWorkload,
            SparseMTTKRPWorkload,
            breakdown_from_counts,
        )
        from repro_torch.core.schedule import program_energy
        from repro_torch.sparse.mesh import mesh_counted_price

        workload = describe(workload)
        if not isinstance(workload, SparseMTTKRPWorkload):
            raise CapabilityError(
                "backend 'psram-mesh' prices fiber-length distributions "
                "(SparseMTTKRPWorkload / MeshSparseMTTKRPWorkload); use "
                "'psram-scheduled' or 'analytical' for dense descriptors"
            )
        if isinstance(workload, MeshSparseMTTKRPWorkload):
            n = workload.n_arrays
            fabric = workload.fabric or self.fabric
            out_rows = workload.reduced_rows
        else:
            n = self.n_arrays or 1
            fabric = self.fabric
            out_rows = None
        price, ps = mesh_counted_price(
            workload.fiber_lengths, workload.rank, self.config,
            n_arrays=n, fabric=fabric, planner=self.planner,
            out_rows=out_rows)
        counts = price.counts
        energy = sum((program_energy(p) for p in ps.programs[1:]),
                     program_energy(ps.programs[0]))
        return Estimate(
            backend=self.name,
            config=self.config,
            workload=workload,
            breakdown=breakdown_from_counts(self.config, counts),
            time_s=price.duration_s(self.config),
            counts=counts,
            energy=energy,
        )


@register("analytical")
class AnalyticalBackend(Backend):
    """The closed-form §V predictive model — cost-only. Asking it to execute
    raises :class:`CapabilityError`; its §V-A dense breakdown equals
    ``psram-scheduled``'s counted cycles exactly, and its mesh price
    (a :class:`~repro_torch.core.perf_model.MeshSparseMTTKRPWorkload`) is
    the per-array stream counts' makespan plus the fabric's all-reduce."""

    def capabilities(self) -> Capabilities:
        return Capabilities(
            executes=False, cost_model=True, matmul=False,
            prices=("dense", "sparse", "matmul"),
            description="closed-form §V sustained-performance model",
        )

    def cost(self, workload) -> Estimate:
        from repro_torch.core.perf_model import (
            MeshSparseMTTKRPWorkload,
            MTTKRPWorkload,
            breakdown_from_counts,
            mesh_sparse_price,
            mttkrp_energy,
            sustained_mttkrp,
        )

        workload = describe(workload)
        if isinstance(workload, MatmulWorkload):
            # the analytical model of one matmul IS its canonical schedule
            return _program_estimate(
                self.name, self.config, _matmul_program(self.config, workload),
                workload)
        if isinstance(workload, MeshSparseMTTKRPWorkload):
            # the mesh closed form: per-array makespan (the same stream
            # counts the counted schedule walks) + the fabric all-reduce
            price = mesh_sparse_price(self.config, workload)
            counts = price.counts
            return Estimate(
                backend=self.name,
                config=self.config,
                workload=workload,
                breakdown=breakdown_from_counts(self.config, counts),
                time_s=price.duration_s(self.config),
                counts=counts,
                energy=None,
            )
        sb = sustained_mttkrp(self.config, workload)
        rate = sb.sustained_petaops * 1e15
        return Estimate(
            backend=self.name,
            config=self.config,
            workload=workload,
            breakdown=sb,
            time_s=2.0 * workload.macs / rate if rate > 0 else float("inf"),
            counts=None,
            energy=mttkrp_energy(self.config, workload)
            if isinstance(workload, MTTKRPWorkload) else None,
        )
