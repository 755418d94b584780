"""Offload scheduling: route a batch's matmul/MTTKRP work by predicted makespan.

The serve loop asks one question per decode batch: *would this batch's
array-shaped work finish sooner on the pSRAM mesh than on the host?* This
module answers it with the repo's own price models — no new cost math:

* **decode batches** — the batch's projection matmuls (the same family-aware
  shape list `offload_report` prices, ``engine._decode_projection_shapes``)
  are each counted through the schedule IR (``api.estimate`` on the
  ``"psram-scheduled"`` backend) and routed across ``n_arrays`` arrays by
  longest-processing-time-first; the modeled bill is the slowest array
  (arrays run concurrently — the same makespan semantics as the sparse mesh
  price). Prices depend only on (model, batch) and are cached.
* **sparse MTTKRP jobs** — delegated wholesale to the mesh machinery:
  ``sparse.partition.plan_partitions`` picks the per-array fiber boundaries
  and ``perf_model.mesh_sparse_price`` bills makespan + the electrical
  all-reduce, so the scheduler and the ``"psram-mesh"`` backend can never
  disagree on a partition.

The *host* side of the comparison is measured, not modeled: the loop feeds
every measured decode-step wall time back via :meth:`observe_host` (EMA per
batch size). Until a batch size has been measured the scheduler offloads
optimistically; afterwards it falls back to host execution whenever the
modeled pSRAM bill loses. Decisions are recorded (target + modeled makespan
next to the measured wall time). There is no photonic silicon behind the
"psram" target: the step runs on the loop's device either way (the card, or
the CPU when asked), so the decision trail is the honest artifact.

A port of ``repro.serve.scheduler``: prices are counted, not measured, so
they equal the reference's field by field.
"""
from __future__ import annotations

import dataclasses
from collections import Counter

from repro_torch import obs
from repro_torch.backends.base import resolve_config
from repro_torch.core.perf_model import (
    MeshFabric,
    MeshSparseMTTKRPWorkload,
    mesh_sparse_price,
)


@dataclasses.dataclass(frozen=True)
class BatchPrice:
    """Modeled pSRAM bill for one batch of work."""

    modeled_s: float              # predicted wall time on the mesh
    makespan_cycles: int          # slowest array's cycles
    reduce_cycles: int            # fabric all-reduce (0 for matmul batches:
                                  # projections are independent)
    n_arrays: int
    per_array_cycles: tuple[int, ...]
    n_units: int                  # matmuls (or partitions) routed


@dataclasses.dataclass(frozen=True)
class OffloadDecision:
    """One routing decision: where the batch should run and why."""

    target: str                   # "psram" | "host"
    modeled_s: float              # the pSRAM bill
    host_s: float | None          # EMA of measured host steps (None = unseen)
    price: BatchPrice

    @property
    def offloaded(self) -> bool:
        return self.target == "psram"


class OffloadScheduler:
    def __init__(self, config=None, n_arrays: int = 4,
                 fabric: MeshFabric | None = None, planner: str = "makespan",
                 backend: str = "psram-scheduled", ema: float = 0.3):
        self.config = resolve_config(config)
        self.n_arrays = int(n_arrays)
        if self.n_arrays < 1:
            raise ValueError("need at least one array")
        self.fabric = fabric
        self.planner = planner
        self.backend_name = backend
        self.ema = float(ema)
        self._decode_prices: dict[tuple, BatchPrice] = {}
        self._host_ema: dict[int, float] = {}
        self._backend = None

    # ------------------------------------------------------------- pricing
    def _be(self):
        if self._backend is None:
            from repro_torch import backends

            self._backend = backends.get(self.backend_name, self.config)
        return self._backend

    def price_decode_batch(self, arch_cfg, batch: int) -> BatchPrice:
        """Modeled mesh bill of one decode step's projection matmuls at
        ``batch`` — counted per unique shape, LPT-routed across arrays."""
        key = (arch_cfg.name, batch, self.n_arrays)
        hit = self._decode_prices.get(key)
        if hit is not None:
            return hit
        from repro_torch import api, backends
        from repro_torch.serve.engine import _decode_projection_shapes

        units: list[int] = []
        for (m, k, n), times in Counter(
                _decode_projection_shapes(arch_cfg, batch)).items():
            est = api.estimate(backends.MatmulWorkload(m, k, n),
                               backend=self._be())
            cycles = (est.counts.total_cycles if est.counts is not None
                      else round(est.time_s * self.config.frequency_ghz * 1e9))
            units.extend([cycles] * times)
        price = self._lpt(units)
        self._decode_prices[key] = price
        return price

    def _lpt(self, unit_cycles: list[int]) -> BatchPrice:
        """Longest-processing-time-first over ``n_arrays`` bins — the
        classic 4/3-optimal makespan heuristic; fine for a bag of a few
        dozen independent matmuls."""
        bins = [0] * self.n_arrays
        for c in sorted(unit_cycles, reverse=True):
            bins[bins.index(min(bins))] += c
        makespan = max(bins) if bins else 0
        return BatchPrice(
            modeled_s=makespan / (self.config.frequency_ghz * 1e9),
            makespan_cycles=int(makespan), reduce_cycles=0,
            n_arrays=self.n_arrays,
            per_array_cycles=tuple(int(b) for b in bins),
            n_units=len(unit_cycles))

    def price_sparse(self, fiber_lengths, rank: int) -> BatchPrice:
        """Modeled mesh bill of a sparse MTTKRP job — the partition planner
        and closed-form price the ``"psram-mesh"`` backend itself uses."""
        wl = MeshSparseMTTKRPWorkload(
            fiber_lengths=fiber_lengths, rank=rank, n_arrays=self.n_arrays,
            fabric=self.fabric)
        price = mesh_sparse_price(self.config, wl, planner=self.planner)
        return BatchPrice(
            modeled_s=price.duration_s(self.config),
            makespan_cycles=int(price.makespan_cycles),
            reduce_cycles=int(price.reduce_cycles),
            n_arrays=price.n_arrays,
            per_array_cycles=tuple(int(c.total_cycles)
                                   for c in price.per_array),
            n_units=len(price.per_array))

    # ------------------------------------------------------------ decisions
    def decide_decode(self, arch_cfg, batch: int) -> OffloadDecision:
        return self._decide(self.price_decode_batch(arch_cfg, batch),
                            self._host_ema.get(batch))

    def decide_sparse(self, fiber_lengths, rank: int,
                      host_s: float | None = None) -> OffloadDecision:
        return self._decide(self.price_sparse(fiber_lengths, rank), host_s)

    @staticmethod
    def _decide(price: BatchPrice, host_s: float | None) -> OffloadDecision:
        # optimistic until the host has been measured; afterwards the
        # modeled pSRAM bill must win or we fall back to host execution
        target = "psram" if host_s is None or price.modeled_s < host_s \
            else "host"
        return OffloadDecision(target=target, modeled_s=price.modeled_s,
                               host_s=host_s, price=price)

    def observe_host(self, batch: int, measured_s: float) -> None:
        """Feed back one measured host decode-step wall time (EMA per
        batch size)."""
        prev = self._host_ema.get(batch)
        self._host_ema[batch] = measured_s if prev is None else \
            (1.0 - self.ema) * prev + self.ema * measured_s

    # ----------------------------------------------------------- degraded
    def mark_array_failed(self, n: int = 1) -> int:
        """An array dropped off the mesh: shrink capacity and re-price.

        Every cached decode price is keyed on ``n_arrays``, so clearing the
        cache makes the next ``decide_decode`` re-bill against the smaller
        mesh — the modeled pSRAM makespan grows, and where it now loses to
        the measured host EMA the decision flips to host execution (the
        host-EMA fallback). The host EMA itself is capacity-independent and
        survives. Returns the surviving array count; the last array cannot
        be failed away (a meshless scheduler prices nothing).
        """
        if n < 1:
            raise ValueError("must fail at least one array")
        survivors = self.n_arrays - int(n)
        if survivors < 1:
            raise ValueError(
                f"cannot fail {n} of {self.n_arrays} arrays: at least one "
                "must survive")
        self.n_arrays = survivors
        self._decode_prices.clear()
        if obs.enabled():
            obs.counter("fault/arrays_lost", n)
        return survivors
