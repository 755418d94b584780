"""Degraded-mode control: finish the MTTKRP when whole arrays die.

The contract that makes recovery exact instead of approximate: the
partition planner never splits a root fiber across arrays, and the eager
per-shard fold is bit-identical to the single-device stream regardless of
array count (both held in tests/test_torch_mesh.py). So a dead array's
contribution is *exactly* the stream of its fiber range, and a run that
lost arrays can be completed in two moves:

1. **Recover** — re-drive each dead shard's fiber range on a surviving
   array (:func:`recover_dead_rows`): one ``stream_mttkrp`` per lost shard,
   rows spliced into the partial output. The result is bit-identical to a
   mesh that never lost the array — and therefore bit-identical to a
   survivors-only plan of the same tensor (the degraded acceptance
   criterion).
2. **Re-plan** — the steady state after the loss: ``plan_partitions`` over
   the survivors (:func:`degraded_mesh_mttkrp` prices both plans, and
   :class:`DegradedReport.throughput_frac` is the honest capacity hit a
   serving scheduler reads).

Recovery work is priced like all other work: the re-driven fiber ranges'
stream programs go through ``count_cycles`` and land in the report next to
the healthy/degraded makespans. The streams run on the CSF's device (on the
card, the ordered fold's chain route, one launch a shard).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.backends.base import resolve_config
from repro_torch.core.psram import PsramConfig

from . import plan as plan_mod


@dataclasses.dataclass(frozen=True)
class DegradedReport:
    """What one degraded run lost, recovered, and now sustains."""

    n_arrays: int
    dead: tuple[int, ...]
    recovered_rows: int            # output rows re-driven on survivors
    recovery_cycles: int           # counted cycles of the re-drive streams
    healthy_makespan_cycles: int   # original plan, all arrays up
    degraded_makespan_cycles: int  # survivors-only re-plan

    @property
    def survivors(self) -> int:
        return self.n_arrays - len(self.dead)

    @property
    def throughput_frac(self) -> float:
        """Sustained degraded throughput as a fraction of healthy (<= 1)."""
        if self.degraded_makespan_cycles <= 0:
            return 1.0
        return self.healthy_makespan_cycles / self.degraded_makespan_cycles

    def recovery_s(self, config: PsramConfig) -> float:
        return self.recovery_cycles / (config.frequency_ghz * 1e9)


def recover_dead_rows(y, meshed, dead, factors,
                      config: PsramConfig | None = None,
                      psram: bool = True, adc_bits: int = 16):
    """Splice the dead arrays' fiber ranges back into a partial output.

    ``y`` is a mesh result where the arrays in ``dead`` contributed
    nothing (their shards zeroed or absent); ``meshed`` is the
    :class:`~repro_torch.sparse.partition.MeshedSparseTensor` the run was
    planned with. Each dead shard re-drives as one single-array stream — the
    eager fold is bit-identical to the mesh's per-shard fold, so the spliced
    result matches a never-failed mesh bit for bit. Returns
    ``(y_recovered, recovery_cycles)``; ``y`` itself is left as it was.
    """
    from repro_torch.core.schedule import count_cycles
    from repro_torch.sparse.stream import stream_mttkrp

    cfg = resolve_config(config)
    y = y.clone()
    cycles = 0
    with obs.span("fault/mesh/degraded", dead=len(dead),
                  n_arrays=len(meshed.partitions)):
        for a in sorted(dead):
            shard = meshed.shards[a]
            if shard.nnz == 0:
                continue
            rows = np.unique(np.asarray(shard.fids[0]))
            with obs.span("fault/mesh/redrive", array=a, nnz=shard.nnz,
                          rows=len(rows)), plan_mod.suspended():
                rec = stream_mttkrp(shard, factors, cfg, psram=psram,
                                    adc_bits=adc_bits)
            idx = torch.from_numpy(rows).to(y.device)
            y[idx] = rec[idx]
            cycles += count_cycles(meshed.programs[a]).total_cycles
            if obs.enabled():
                obs.counter("fault/recovered_rows", len(rows))
    return y, cycles


def degraded_mesh_mttkrp(tensor, factors, mode: int = 0,
                         config: PsramConfig | None = None,
                         n_arrays: int = 4,
                         dead_arrays: tuple[int, ...] | None = None,
                         planner: str = "makespan",
                         psram: bool = True, adc_bits: int = 16):
    """Run, lose arrays, recover, re-plan — the whole degraded-mode story.

    ``dead_arrays`` defaults to the armed :class:`FaultPlan`'s
    ``ArrayLoss`` entries. The faulty run is the planned per-shard fold
    with dead shards contributing nothing (the mesh sum with their partials
    left out — on the eager lowering this is bit-identical to the real
    mesh); recovery re-drives each lost fiber range on a survivor; the
    re-plan prices the survivors-only steady state. Returns ``(y,
    DegradedReport)`` where ``y`` is bit-identical to a survivors-only plan
    of the same tensor.
    """
    from repro_torch.sparse.formats import CSF, csf_for_mode
    from repro_torch.sparse.partition import partition_csf, partition_fiber_lengths
    from repro_torch.sparse.stream import stream_mttkrp

    cfg = resolve_config(config)
    csf = tensor if isinstance(tensor, CSF) else csf_for_mode(tensor, mode)
    factors = tuple(factors)
    rank = int(factors[0].shape[-1])
    plan = plan_mod.active()
    if dead_arrays is None:
        dead_arrays = tuple(sorted(plan.dead_arrays)) if plan is not None \
            else ()
    dead = tuple(a for a in dead_arrays if a < n_arrays)
    if len(dead) >= n_arrays:
        raise ValueError(f"all {n_arrays} arrays dead — nothing survives")
    if obs.enabled() and dead:
        obs.counter("fault/arrays_lost", len(dead))

    meshed = partition_csf(csf, n_arrays=n_arrays, rank=rank, config=cfg,
                           planner=planner)
    out_rows = csf.shape[csf.mode_order[0]]
    y = torch.zeros((out_rows, rank), dtype=torch.float32, device=csf.device)
    for a, shard in enumerate(meshed.shards):
        if a in dead or shard.nnz == 0:
            continue
        y = y + stream_mttkrp(shard, factors, cfg, psram=psram,
                              adc_bits=adc_bits)

    y, rec_cycles = recover_dead_rows(y, meshed, dead, factors, cfg,
                                      psram=psram, adc_bits=adc_bits)

    survivors = n_arrays - len(dead)
    f = csf.fiber_lengths()
    degraded_plan = partition_fiber_lengths(f, survivors, rank, cfg,
                                            planner=planner)
    report = DegradedReport(
        n_arrays=n_arrays,
        dead=dead,
        recovered_rows=sum(
            len(np.unique(np.asarray(meshed.shards[a].fids[0])))
            for a in dead),
        recovery_cycles=rec_cycles,
        healthy_makespan_cycles=meshed.critical_path_cycles,
        degraded_makespan_cycles=degraded_plan.critical_path_cycles,
    )
    return y, report
