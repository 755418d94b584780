"""The paper's predictive performance model (§V), extended.

The paper reports sustained MTTKRP performance that scales linearly with both
operating frequency and wavelength-channel count (Fig. 5) and peaks at
**17 PetaOps** for the practical configuration: 256x32 words, 52 channels,
20 GHz, 8-bit precision. That figure is exactly the array's MAC roofline:

    2 ops/MAC x (256*32 words) x 52 lambda x 20 GHz = 17.04 PetaOps

``peak_ops`` reproduces that headline. ``sustained_mttkrp`` extends the model
(beyond the paper, flagged as such) with the schedule-derived utilization
terms for the CP1->CP2->CP3 mapping: array fill (rank vs rows / word columns),
wavelength occupancy of the interleave, and the 20 GHz write-rate bound on
reconfiguring the array between tiles.

Pure Python and numpy, the same arithmetic as the reference module, so the
port's counts and closed forms equal the reference's. Beside the array model
the port carries a roofline of one NVIDIA H100 on the same MTTKRP
(:func:`h100_mttkrp_time_s`, :func:`h100_ops_per_joule`): the reference's
comparison chip is a TPU, whose figures the port does not keep.
"""
from __future__ import annotations

import dataclasses
import math

from .psram import PsramConfig


@dataclasses.dataclass(frozen=True)
class MTTKRPWorkload:
    """Dense 3-mode MTTKRP workload (paper §V-A uses I=J=K=1e6)."""

    i: int = 10**6
    j: int = 10**6
    k: int = 10**6
    rank: int = 32
    nnz: int | None = None  # None => dense (i*j*k nonzeros)

    @property
    def nonzeros(self) -> int:
        return self.nnz if self.nnz is not None else self.i * self.j * self.k

    @property
    def macs(self) -> int:
        # CP1 (R muls) + CP2 (R muls) per nonzero; CP3 adds are electrical
        # and overlapped (§III-C), counted as the +R adds inside the 2 ops/MAC.
        return 2 * self.rank * self.nonzeros


@dataclasses.dataclass(frozen=True)
class SparseMTTKRPWorkload:
    """Sparse MTTKRP described by its *real* fiber-length distribution.

    ``fiber_lengths[r]`` is the nonzero count of the r-th nonempty output
    row (``CSF.fiber_lengths()``); every term of the sustained model derives
    from it instead of the dense ``nnz // i`` occupancy proxy, because with
    power-law fibers the proxy is wrong by orders of magnitude: a block of
    one mega-fiber drives a single channel, a block of 256 singleton fibers
    needs five optical cycles to drain its segments.
    """

    fiber_lengths: tuple[int, ...] | object   # sequence / np array of int
    rank: int = 32

    @property
    def nonzeros(self) -> int:
        import numpy as np
        return int(np.asarray(self.fiber_lengths).sum())

    @property
    def n_fibers(self) -> int:
        import numpy as np
        f = np.asarray(self.fiber_lengths)
        return int((f > 0).sum())

    @property
    def macs(self) -> int:
        # same convention as MTTKRPWorkload: CP1+CP2 muls, CP3 folded into
        # the 2 ops/MAC
        return 2 * self.rank * self.nonzeros


@dataclasses.dataclass(frozen=True)
class MeshSparseMTTKRPWorkload(SparseMTTKRPWorkload):
    """A sparse MTTKRP spanning ``n_arrays`` pSRAM arrays joined by an
    electrical reduction fabric.

    Subclasses :class:`SparseMTTKRPWorkload`, so single-array consumers see
    the whole-tensor view unchanged; mesh-aware backends (``"analytical"``
    and ``"psram-mesh"``, :mod:`repro_torch.sparse.mesh`) price the split:
    per-array makespan (arrays run
    concurrently) plus the fabric's all-reduce of the ``(out_rows, rank)``
    partial outputs. ``out_rows`` defaults to the nonempty-row count
    (``n_fibers``) — override it with the full output-mode dimension to bill
    the fabric for reducing the dense output block.
    """

    n_arrays: int = 1
    out_rows: int | None = None
    fabric: "MeshFabric | None" = None

    @property
    def reduced_rows(self) -> int:
        return self.n_fibers if self.out_rows is None else int(self.out_rows)


@dataclasses.dataclass(frozen=True)
class MeshFabric:
    """The electrical reduction fabric joining pSRAM arrays.

    The system-level follow-on (arxiv 2602.00892) keeps the reduction
    electrical: per all-reduce step each array moves+adds ``reduce_words``
    f32 words per fabric cycle, and the fabric runs at the array clock. A
    butterfly over ``A`` arrays needs ``ceil(log2 A)`` steps.
    """

    reduce_words: int = 256

    def allreduce_cycles(self, out_rows: int, rank: int,
                         n_arrays: int) -> int:
        """Fabric cycles to all-reduce an ``(out_rows, rank)`` f32 partial
        output across ``n_arrays`` arrays — 0 on a single array, and 0 for
        an empty output (nothing to move)."""
        if n_arrays <= 1 or out_rows <= 0 or rank <= 0:
            return 0
        steps = math.ceil(math.log2(n_arrays))
        return steps * -(-(out_rows * rank) // self.reduce_words)


DEFAULT_FABRIC = MeshFabric()


def allreduce_cycles(out_rows: int, rank: int, n_arrays: int,
                     fabric: MeshFabric | None = None) -> int:
    """Module-level front door of :meth:`MeshFabric.allreduce_cycles` — the
    ONE closed form both the analytical mesh price and the counted mesh
    schedule use, so estimate==measured can hold exactly at mesh scale."""
    return (fabric or DEFAULT_FABRIC).allreduce_cycles(out_rows, rank,
                                                       n_arrays)


def peak_ops(cfg: PsramConfig) -> float:
    """Paper headline model: ops/s, linear in frequency and channels (Fig. 5)."""
    cfg.validate()
    return 2.0 * cfg.words * cfg.wavelengths * cfg.frequency_ghz * 1e9


def peak_petaops(cfg: PsramConfig) -> float:
    return peak_ops(cfg) / 1e15


@dataclasses.dataclass(frozen=True)
class SustainedBreakdown:
    peak_petaops: float
    fill_utilization: float        # fraction of words holding live operands
    wavelength_occupancy: float    # channels used / channels available
    reconfig_efficiency: float     # compute cycles / (compute + write cycles)
    sustained_petaops: float

    @property
    def utilization(self) -> float:
        return self.fill_utilization * self.wavelength_occupancy * self.reconfig_efficiency


def sustained_mttkrp(
    cfg: PsramConfig, wl: "MTTKRPWorkload | SparseMTTKRPWorkload"
) -> SustainedBreakdown:
    """Schedule-aware sustained performance of MTTKRP on one array.

    Dense mapping (Figs. 3-4): factor rows live down array columns, R
    elements per column. A tile therefore covers min(R, rows) rank elements
    x word_cols concurrent rows-of-B, and each optical cycle retires one
    CP1/CP2 slice per wavelength channel.

    A :class:`SparseMTTKRPWorkload` dispatches to the sparse streaming model
    instead — occupancy from the workload's real fiber-length distribution.
    """
    if isinstance(wl, SparseMTTKRPWorkload):
        return sustained_sparse_mttkrp(cfg, wl)
    cfg.validate()
    peak = peak_petaops(cfg)

    # --- array fill: each stored factor row occupies R cells down a column;
    # multiple rank-R segments pack into the 256 rows (Fig. 3's interleave
    # stacks floor(rows/R) different b_i rows per column), so only the
    # remainder rows are dark. For R=32 on 256 rows the array is full.
    rank_rows = min(wl.rank, cfg.rows)
    packed = max(1, cfg.rows // rank_rows)
    fill = (packed * rank_rows) / cfg.rows

    # --- wavelength occupancy: the interleave issues one independent
    # (j,k)-pair per channel; occupancy is full whenever there are at least
    # `wavelengths` pending nonzero chains per stored tile, which holds for
    # the paper's 1e6-per-mode dense tensor. For tiny tensors it degrades.
    pending = max(1, wl.nonzeros // max(1, wl.i))  # chains per output row
    occ = min(1.0, pending / cfg.wavelengths)

    # --- reconfiguration: a stored tile (word_cols rows of B) is reused for
    # all K values sharing the same j before a rewrite; rewriting takes `rows`
    # write cycles at the same 20 GHz clock (one word-line per write cycle).
    reuse_cycles = max(1, wl.k // cfg.wavelengths)  # compute cycles per tile
    reconf = reuse_cycles / (reuse_cycles + cfg.rows)

    sustained = peak * fill * occ * reconf
    return SustainedBreakdown(
        peak_petaops=peak,
        fill_utilization=fill,
        wavelength_occupancy=occ,
        reconfig_efficiency=reconf,
        sustained_petaops=sustained,
    )


def sustained_sparse_mttkrp(
    cfg: PsramConfig, wl: SparseMTTKRPWorkload
) -> SustainedBreakdown:
    """Sustained performance of the *streaming* sparse schedule
    (repro_torch.sparse.stream), predicted from the fiber-length distribution.

    Model of one array: the sorted nonzero stream is cut into blocks of
    ``rows`` chain rows; writing a block costs one cycle per nonzero per
    rank-tile, and draining it costs ``ceil(segments / wavelengths)`` optical
    cycles per rank-tile, where ``segments`` counts the output rows
    intersecting the block (a fiber spanning blocks re-occupies a channel in
    each). Fill is the stored-block occupancy, wavelength occupancy is
    segments over channel-cycles offered — both direct functions of the
    distribution, not of an ``nnz // i`` average. The block layout is the
    scheduler's own (``schedule.stream_block_layout``); the closed forms
    below aggregate it without building the op list, and
    ``measured_utilization(build_stream_program(...))`` must agree within 5%
    on the §V-A configuration.
    """
    cfg.validate()
    return breakdown_from_counts(
        cfg, stream_counts(cfg, wl.fiber_lengths, wl.rank))


def stream_counts(cfg: PsramConfig, fiber_lengths, rank: int):
    """Closed-form :class:`~repro_torch.core.schedule.CycleCounts` of the streaming
    schedule for one array — equal, field for field, to
    ``count_cycles(build_stream_program(fiber_lengths, rank, cfg))`` without
    building the op list. An empty
    distribution counts zero everything: empty shards of a multi-array
    split are priced at zero cycles."""
    from .schedule import CycleCounts, stream_block_layout

    nnz_b, seg_b = stream_block_layout(fiber_lengths, cfg.rows)
    nnz = int(nnz_b.sum())
    rank = int(rank)
    tiles = -(-rank // cfg.word_cols)
    if nnz == 0:
        return CycleCounts(0, 0, 0, 0, 0, 0)
    drain_b = -(-seg_b // cfg.wavelengths)
    return CycleCounts(
        write_cycles=tiles * nnz,
        compute_cycles=tiles * int(drain_b.sum()),
        macs=nnz * rank,
        channel_cycles=tiles * int(seg_b.sum()),
        live_word_cycles=rank * int((drain_b * nnz_b).sum()),
        stores=tiles * len(nnz_b),
    )


@dataclasses.dataclass(frozen=True)
class MeshPrice:
    """Price of one sparse MTTKRP across a mesh of arrays.

    ``per_array`` holds every array's counted cycles (empty shards count
    zero); arrays run concurrently, so the execution term is the makespan
    (slowest array), and the fabric's all-reduce of the partial outputs is
    serialized after it. ``counts`` sums the per-array work — the energy /
    utilization view, *not* the latency view.
    """

    per_array: tuple
    reduce_cycles: int
    n_arrays: int

    @property
    def makespan_cycles(self) -> int:
        return max(c.total_cycles for c in self.per_array)

    @property
    def total_cycles(self) -> int:
        return self.makespan_cycles + self.reduce_cycles

    @property
    def counts(self):
        per = list(self.per_array)
        return sum(per[1:], per[0])

    def duration_s(self, cfg: PsramConfig) -> float:
        return self.total_cycles / (cfg.frequency_ghz * 1e9)


def mesh_sparse_price(
    cfg: PsramConfig,
    wl: "SparseMTTKRPWorkload | MeshSparseMTTKRPWorkload",
    n_arrays: int | None = None,
    fabric: MeshFabric | None = None,
    planner: str = "makespan",
) -> MeshPrice:
    """Analytical price of a sparse MTTKRP split over ``n_arrays`` pSRAM
    arrays: per-array closed-form stream counts on the planner's own
    partition boundaries, plus the electrical all-reduce of the partial
    outputs. The planner is ``sparse.partition.plan_partitions``, the one
    the executing ``"psram-mesh"`` backend (``sparse.mesh``) counts on, and
    the closed forms are :func:`stream_counts`, equal field for field to the
    counted stream schedule.
    """
    import numpy as np

    from repro_torch.sparse.partition import plan_partitions

    cfg.validate()
    if isinstance(wl, MeshSparseMTTKRPWorkload):
        n_arrays = wl.n_arrays if n_arrays is None else n_arrays
        fabric = wl.fabric if fabric is None else fabric
        out_rows = wl.reduced_rows
    else:
        out_rows = wl.n_fibers
    n_arrays = 1 if n_arrays is None else int(n_arrays)
    f = np.asarray(wl.fiber_lengths, dtype=np.int64)
    parts = plan_partitions(f, n_arrays, wl.rank, cfg, planner=planner)
    per = tuple(
        stream_counts(cfg, f[p.fiber_start:p.fiber_stop], wl.rank)
        for p in parts
    )
    return MeshPrice(
        per_array=per,
        reduce_cycles=allreduce_cycles(out_rows, wl.rank, n_arrays, fabric),
        n_arrays=n_arrays,
    )


def breakdown_from_counts(cfg: PsramConfig, counts) -> SustainedBreakdown:
    """Build the §V utilization breakdown from counted cycles.

    ``counts`` is a ``core.schedule.CycleCounts`` (possibly summed over
    several programs) — useful when the counts are already in hand and
    re-walking the op list would be wasteful.
    """
    peak = peak_petaops(cfg)
    fill = counts.fill_utilization(cfg)
    occ = counts.wavelength_occupancy(cfg)
    reconf = counts.reconfig_efficiency()
    return SustainedBreakdown(
        peak_petaops=peak,
        fill_utilization=fill,
        wavelength_occupancy=occ,
        reconfig_efficiency=reconf,
        sustained_petaops=peak * fill * occ * reconf,
    )


def measured_utilization(program) -> SustainedBreakdown:
    """Counted-cycle counterpart of :func:`sustained_mttkrp`'s breakdown.

    Takes a ``core.schedule.TileProgram`` and derives the same fill /
    wavelength-occupancy / reconfiguration terms from the accountant's
    counted cycles instead of the closed-form §V model. The two must agree
    on any schedule both can describe (asserted within 5% on the paper's
    §V-A configuration) — this is what validates
    the analytical model against the executable schedule.
    """
    from .schedule import count_cycles

    return breakdown_from_counts(program.config, count_cycles(program))


def sweep_channels(freq_ghz: float = 20.0, channels=range(4, 53, 4)) -> list[tuple[int, float]]:
    """Fig. 5(i): sustained PetaOps vs wavelength channels at fixed frequency."""
    wl = MTTKRPWorkload()
    out = []
    for ch in channels:
        cfg = PsramConfig(wavelengths=ch, frequency_ghz=freq_ghz)
        out.append((ch, sustained_mttkrp(cfg, wl).sustained_petaops))
    return out


def sweep_frequency(channels: int = 52, freqs=(1, 2, 5, 10, 15, 20)) -> list[tuple[float, float]]:
    """Fig. 5(ii): sustained PetaOps vs operating frequency at fixed channels."""
    wl = MTTKRPWorkload()
    out = []
    for f in freqs:
        cfg = PsramConfig(wavelengths=channels, frequency_ghz=float(f))
        out.append((float(f), sustained_mttkrp(cfg, wl).sustained_petaops))
    return out


def time_to_solution_s(cfg: PsramConfig, wl: MTTKRPWorkload) -> float:
    """Wall-clock for one full MTTKRP at the sustained rate."""
    rate = sustained_mttkrp(cfg, wl).sustained_petaops * 1e15
    return 2.0 * wl.macs / rate  # 2 ops per MAC


# ---------------------------------------------------------------------------
# energy model (beyond-paper extension, from the paper's §III-B device data)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EnergySpec:
    """Per-device energies. Bitcell numbers are the paper's (§III-B, [15]):
    ~1.04 pJ/bit switching (write), ~16.7 aJ/bit static. Comb/modulator/ADC
    are parameterized with literature-typical defaults."""

    write_pj_per_bit: float = 1.04
    static_aj_per_bit: float = 16.7
    modulator_fj_per_bit: float = 50.0    # comb-shaper modulation
    adc_pj_per_conversion: float = 1.0    # high-speed on-chip ADC
    laser_wall_w: float = 2.0             # comb source + thermal tuning


@dataclasses.dataclass(frozen=True)
class EnergyBreakdown:
    write_j: float
    static_j: float
    modulate_j: float
    adc_j: float
    laser_j: float

    @property
    def total_j(self) -> float:
        return self.write_j + self.static_j + self.modulate_j + self.adc_j + self.laser_j

    def __add__(self, other: "EnergyBreakdown") -> "EnergyBreakdown":
        return EnergyBreakdown(
            self.write_j + other.write_j,
            self.static_j + other.static_j,
            self.modulate_j + other.modulate_j,
            self.adc_j + other.adc_j,
            self.laser_j + other.laser_j,
        )


def mttkrp_energy(cfg: PsramConfig, wl: MTTKRPWorkload, spec: EnergySpec | None = None) -> EnergyBreakdown:
    """Energy for one full MTTKRP on the array at the sustained rate."""
    spec = spec or EnergySpec()
    t = time_to_solution_s(cfg, wl)
    # array rewrites: each tile of stored operands is written once per reuse
    # window (see sustained_mttkrp's reconfiguration term)
    tiles = max(1, wl.nonzeros // max(1, cfg.wavelengths * max(1, wl.k // cfg.wavelengths)))
    bits_per_tile = cfg.rows * cfg.bits_per_row
    write_j = tiles * bits_per_tile * spec.write_pj_per_bit * 1e-12
    static_j = cfg.rows * cfg.bits_per_row * spec.static_aj_per_bit * 1e-18 \
        * t * cfg.frequency_ghz * 1e9
    # every input element is modulated once per wavelength-cycle
    inputs = 2.0 * wl.rank * wl.nonzeros / max(cfg.wavelengths, 1)
    modulate_j = inputs * 8 * spec.modulator_fj_per_bit * 1e-15
    conversions = wl.rank * wl.nonzeros / max(cfg.wavelengths, 1)
    adc_j = conversions * spec.adc_pj_per_conversion * 1e-12
    laser_j = spec.laser_wall_w * t
    return EnergyBreakdown(write_j, static_j, modulate_j, adc_j, laser_j)


def ops_per_joule(cfg: PsramConfig, wl: MTTKRPWorkload) -> float:
    e = mttkrp_energy(cfg, wl).total_j
    return 2.0 * wl.macs / max(e, 1e-30)


# ---------------------------------------------------------------------------
# the same MTTKRP on one NVIDIA H100: a roofline
# ---------------------------------------------------------------------------
#
# NVIDIA's data sheet figures for the H100 SXM5 80GB, dense rates without
# sparsity, at the full 700 W power limit (the card the port is measured on
# reads "NVIDIA H100 80GB HBM3, 700.00 W"). A card set below 700 W runs
# slower under load.

H100_HBM_BYTES_PER_S = 3.35e12
H100_INT8_OPS_PER_S = 1979e12
H100_BF16_FLOPS_PER_S = 989e12
H100_F32_FLOPS_PER_S = 67e12          # outside the tensor cores
H100_POWER_LIMIT_W = 700.0


def h100_mttkrp_time_s(wl: MTTKRPWorkload, int8: bool = True) -> float:
    """Roofline time for the same MTTKRP on one H100: the compute term
    (``2 * macs`` operations at the int8 or bf16 peak) against the memory
    term (streaming the tensor once, one or two bytes a nonzero, factors
    resident), whichever is larger."""
    ops = 2.0 * wl.macs
    peak = H100_INT8_OPS_PER_S if int8 else H100_BF16_FLOPS_PER_S
    bytes_streamed = wl.nonzeros * (1 if int8 else 2)
    return max(ops / peak, bytes_streamed / H100_HBM_BYTES_PER_S)


def h100_ops_per_joule(wl: MTTKRPWorkload, int8: bool = True) -> float:
    """Operations a joule for the roofline's time at the card's power limit."""
    t = h100_mttkrp_time_s(wl, int8=int8)
    return 2.0 * wl.macs / (H100_POWER_LIMIT_W * t)
