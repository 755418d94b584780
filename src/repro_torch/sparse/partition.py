"""nnz-balanced partitioning of a sparse tensor over a mesh of pSRAM arrays.

One array streams one contiguous range of output rows (root fibers of the
CSF); the partitioner picks the row boundaries so every array sees (close
to) the same nonzero count — with power-law fibers an equal-*rows* split can
be off by orders of magnitude, so balance is computed on the fiber-length
cumsum.

Ported: the planners (:func:`nnz_balanced_partitions`,
:func:`makespan_partitions`, :func:`plan_partitions`) and :func:`imbalance`
— pure numpy, the same boundaries as the reference's — which both the
executing mesh path (``sparse.mesh``) and the analytical mesh price
(``core.perf_model.mesh_sparse_price``) plan on;
:class:`PartitionedSchedule` / :func:`partition_fiber_lengths`, the planned
split with its per-array stream programs from the fiber lengths alone, which
``obs.mesh_timeline`` renders; :class:`MeshedSparseTensor` /
:func:`partition_csf`, the split of a CSF into its shards; and
:func:`arrays_for_mesh`, the array count a mesh gives under the
``dist.sharding`` rule set, which ``partition_csf(mesh=)`` asks.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.backends.base import resolve_config
from repro_torch.core.psram import PsramConfig
from repro_torch.dist.sharding import _axis_sizes, logical_to_spec
from repro_torch.core.schedule import CycleCounts, TileProgram, count_cycles

from .formats import CSF
from .stream import build_stream_program


@dataclasses.dataclass(frozen=True)
class Partition:
    """One array's share: root fibers ``fiber_start:fiber_stop`` of the CSF
    (``nnz`` nonzeros)."""

    array_id: int
    fiber_start: int
    fiber_stop: int
    nnz: int


def nnz_balanced_partitions(fiber_lengths: np.ndarray,
                            n_arrays: int) -> list[Partition]:
    """Cut the fiber list into ``n_arrays`` contiguous, nnz-balanced ranges.

    Boundaries are the fibers whose cumulative nonzero count crosses the
    equal-share targets; a fiber is never split across arrays (its segment
    carry must stay on one array's electrical accumulator).

    Degrades gracefully when there are fewer fibers (or nonzeros) than
    arrays: the surplus arrays receive *empty* ranges (``fiber_start ==
    fiber_stop``, ``nnz == 0``), priced at zero cycles everywhere.
    """
    f = np.asarray(fiber_lengths, dtype=np.int64)
    if n_arrays < 1:
        raise ValueError("need at least one array")
    ends = np.cumsum(f)
    total = int(ends[-1]) if len(ends) else 0
    targets = (np.arange(1, n_arrays) * total) / n_arrays
    cuts = np.searchsorted(ends, targets, side="left") + 1
    bounds = np.concatenate(([0], np.clip(cuts, 0, len(f)), [len(f)]))
    bounds = np.maximum.accumulate(bounds)
    # a mega-fiber crossing several equal-share targets collapses the cuts
    # behind it; give every array at least one fiber while fibers remain
    for a in range(1, n_arrays):
        lo = bounds[a - 1] + 1
        hi = len(f) - (n_arrays - a)
        if lo <= hi:
            bounds[a] = min(max(bounds[a], lo), max(lo, hi))
    out = []
    for a in range(n_arrays):
        lo, hi = int(bounds[a]), int(bounds[a + 1])
        out.append(Partition(
            array_id=a, fiber_start=lo, fiber_stop=hi,
            nnz=int(f[lo:hi].sum()),
        ))
    return out


def makespan_partitions(
    fiber_lengths: np.ndarray,
    n_arrays: int,
    rank: int,
    config: PsramConfig | None = None,
    max_passes: int = 8,
) -> list[Partition]:
    """Route fibers across arrays by *predicted makespan* instead of raw nnz.

    Starts from the nnz-balanced cut and greedily shifts partition
    boundaries fiber by fiber while the predicted per-array cycle count
    (``perf_model.stream_counts`` — the closed form that equals the counted
    schedule exactly) of the heavier neighbor drops. nnz balance is a proxy:
    two arrays with equal nonzeros can differ in drain cycles by the segment
    structure of their fibers (many singleton fibers cost
    ``ceil(segments/wavelengths)`` extra optical cycles per block), and the
    makespan is set by the slowest array alone.
    """
    from repro_torch.core.perf_model import stream_counts

    cfg = resolve_config(config)
    f = np.asarray(fiber_lengths, dtype=np.int64)
    parts = nnz_balanced_partitions(f, n_arrays)
    bounds = [p.fiber_start for p in parts] + [len(f)]

    def cycles(a: int) -> int:
        return stream_counts(
            cfg, f[bounds[a]:bounds[a + 1]], rank).total_cycles

    cyc = [cycles(a) for a in range(n_arrays)]
    for _ in range(max_passes):
        moved = False
        for a in range(1, n_arrays):
            # boundary between arrays a-1 and a: shift it toward the
            # lighter side while the pair's max predicted cycles drops
            while True:
                left, right = cyc[a - 1], cyc[a]
                if left > right and bounds[a] - bounds[a - 1] > 1:
                    trial = bounds[a] - 1
                elif right > left and bounds[a + 1] - bounds[a] > 1:
                    trial = bounds[a] + 1
                else:
                    break
                old = bounds[a]
                bounds[a] = trial
                nl, nr = cycles(a - 1), cycles(a)
                if max(nl, nr) < max(left, right):
                    cyc[a - 1], cyc[a] = nl, nr
                    moved = True
                else:
                    bounds[a] = old
                    break
        if not moved:
            break
    return [
        Partition(array_id=a, fiber_start=int(bounds[a]),
                  fiber_stop=int(bounds[a + 1]),
                  nnz=int(f[bounds[a]:bounds[a + 1]].sum()))
        for a in range(n_arrays)
    ]


PLANNERS = ("nnz", "makespan")


def plan_partitions(
    fiber_lengths: np.ndarray,
    n_arrays: int,
    rank: int,
    config: PsramConfig | None = None,
    planner: str = "makespan",
) -> list[Partition]:
    """The one partition-planning front door: ``"nnz"`` is the balanced-cut
    baseline, ``"makespan"`` (default) refines it by predicted per-array
    cycles. The analytical mesh price plans on THIS function, as the
    executing mesh path will, so the two agree on the boundaries."""
    if planner not in PLANNERS:
        raise ValueError(f"unknown planner {planner!r}; pick one of {PLANNERS}")
    if planner == "nnz":
        return nnz_balanced_partitions(fiber_lengths, n_arrays)
    return makespan_partitions(fiber_lengths, n_arrays, rank, config)


def imbalance(parts: list[Partition]) -> float:
    """max/mean nonzero load — 1.0 is perfect balance."""
    loads = np.asarray([p.nnz for p in parts], dtype=np.float64)
    mean = loads.mean()
    return float(loads.max() / mean) if mean > 0 else 1.0


def arrays_for_mesh(mesh, logical_axis: str = "batch", rules=None) -> int:
    """How many ways the output mode shards on ``mesh`` — the product of the
    mesh axes that ``logical_axis`` claims under the dist.sharding rules.

    Uses a claim-friendly dummy dimension (the product of all axis sizes) so
    the answer reflects the rule set, not a divisibility accident; the
    nnz-balanced cut itself never needs divisibility.
    """
    sizes = _axis_sizes(mesh)
    total = math.prod(sizes.values())
    entry = logical_to_spec((logical_axis,), (total,), mesh, rules=rules)[0]
    if entry is None:
        return 1
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    return math.prod(sizes[a] for a in axes)


@dataclasses.dataclass(frozen=True)
class PartitionedSchedule:
    """An nnz-balanced multi-array split with its per-array stream programs
    — the one place the multi-array aggregates (summed counts, makespan,
    load imbalance) are defined."""

    partitions: tuple[Partition, ...]
    programs: tuple[TileProgram, ...]

    @property
    def counts(self) -> CycleCounts:
        """Summed counted cycles of every array's stream program."""
        per = [count_cycles(p) for p in self.programs]
        return sum(per[1:], per[0])

    @property
    def critical_path_cycles(self) -> int:
        """Arrays run concurrently: makespan is the slowest array."""
        return max(count_cycles(p).total_cycles for p in self.programs)

    @property
    def imbalance(self) -> float:
        return imbalance(list(self.partitions))


def partition_fiber_lengths(
    fiber_lengths,
    n_arrays: int,
    rank: int,
    config: PsramConfig | None = None,
    planner: str = "nnz",
) -> PartitionedSchedule:
    """Planned split + per-array stream programs from the fiber-length
    distribution alone (no coordinates needed — paper-scale pricing).
    ``planner`` picks the boundary rule (see :func:`plan_partitions`);
    the historical default stays the nnz-balanced cut."""
    cfg = resolve_config(config)
    f = np.asarray(fiber_lengths, dtype=np.int64)
    parts = plan_partitions(f, n_arrays, rank, cfg, planner=planner)
    programs = tuple(
        build_stream_program(f[p.fiber_start:p.fiber_stop], rank, cfg)
        for p in parts
    )
    return PartitionedSchedule(partitions=tuple(parts), programs=programs)


@dataclasses.dataclass(frozen=True)
class MeshedSparseTensor(PartitionedSchedule):
    """A CSF split over a mesh of arrays, with the per-array schedules."""

    shards: tuple[CSF, ...] = ()


def partition_csf(
    csf: CSF,
    mesh=None,
    n_arrays: int | None = None,
    rank: int | None = None,
    config: PsramConfig | None = None,
    logical_axis: str = "batch",
    rules=None,
    planner: str = "nnz",
) -> MeshedSparseTensor:
    """Span ``csf`` over ``n_arrays`` pSRAM arrays.

    ``rank`` is required to build the per-array programs. Each shard keeps
    original coordinates (``CSF.slice_roots``), so per-array results add
    straight into the global output. Shards may be empty when fibers <
    arrays — their programs are empty and price zero. ``mesh`` (a model
    mesh or an array mesh) gives the array count instead: the
    ``dist.sharding`` claim of ``logical_axis`` under ``rules``
    (:func:`arrays_for_mesh`).
    """
    if (mesh is None) == (n_arrays is None):
        raise ValueError("pass exactly one of mesh / n_arrays")
    if mesh is not None:
        n_arrays = arrays_for_mesh(mesh, logical_axis, rules)
    if rank is None:
        raise ValueError("rank is required to build the per-array schedules")
    ps = partition_fiber_lengths(csf.fiber_lengths(), n_arrays, rank, config,
                                 planner=planner)
    shards = tuple(
        csf.slice_roots(p.fiber_start, p.fiber_stop) for p in ps.partitions
    )
    return MeshedSparseTensor(
        partitions=ps.partitions, programs=ps.programs, shards=shards,
    )
