"""Tile-schedule IR for the pSRAM engine — the layer every path lowers through.

The paper's 17-PetaOps headline (§V) is a property of a *schedule*, not of a
single MAC: operand tiles are written into the 256x32 array (one word-line per
20 GHz write cycle), driven for a reuse window over up to 52 WDM channels
(§IV's CP mapping, Figs. 3-4), then rewritten. This module makes that
schedule a first-class object — a small tile program of :class:`StoreTile`
and :class:`Drive` ops with explicit cycle costs — and provides two
interpreters plus an accountant over it:

* :func:`execute` — the **vectorized executor**: pads the operands into tile
  stacks, runs every tile's optical cycle as one batched exact contraction
  (``torch.bmm`` on the tensors' device), and folds K-tiles in schedule
  order so the result is *bit-identical* to the per-cycle reference below.
  The K-tiles go through in chunks whose working set stays under
  ``_CHUNK_BYTES`` (and the N-tiles in blocks where one K-tile alone would
  pass it), the fold carried across chunks in order: the bits do not depend
  on the chunking.
* :func:`execute_reference` — the **per-cycle oracle**: walks the program op
  by op, programming a :class:`~repro_torch.core.psram.PsramArray` on every
  ``StoreTile`` and issuing one ``multiply_accumulate`` per ``Drive`` — the
  array physics of §III/§IV, slow but transparently faithful.
* :func:`count_cycles` / :func:`program_energy` — the **accountant**: counts
  compute vs. write cycles, channel- and live-word-occupancy, and maps them
  onto :class:`~repro_torch.core.perf_model.EnergySpec` device energies.

``core.psram`` holds only array physics (what one optical cycle does); this
module holds the schedule (which cycles happen, in what order, at what
cost); ``core.perf_model`` is the closed-form model of §V whose
``sustained_mttkrp`` breakdown is validated against :func:`count_cycles`
via ``perf_model.measured_utilization``.

Sparse MTTKRP adds a third op: :class:`GatherDrive`, the nonzero-streaming
schedule of ``repro_torch.sparse.stream`` (store a block of CP2 chain rows,
drive per-output-row gather masks per WDM channel), priced by the same
counters.

``compiled=True`` runs :func:`compiled_matmul_executor`: on a CUDA tensor
the eager executor captured once in a ``torch.cuda.CUDAGraph`` (its working
set in the graph's private pool) and replayed; on a CPU tensor the eager
executor itself. Both interpreters record the reference's ``obs`` spans
and counters (``schedule/execute/matmul`` with
``schedule/programs_executed``, ``schedule/execute/reference`` with
``schedule/reference_ops``).

The vectorized executor carries the reference's fault hooks
(``repro_torch.faults``): while a :class:`~repro_torch.faults.FaultPlan`
that touches the array path is armed, stuck cells corrupt the stored words
and drive-path faults (laser drift, dead WDM channels, transient spikes)
land on the analog accumulation before the ADC, at the reference's sites
for the same seed (:class:`_FaultSites`). While any plan is armed the
compiled executor runs the eager one: no graph is captured with a fault in
it, and none captured earlier is replayed. Disarmed, the hooks cost one read
of ``faults.plan._ACTIVE``.
"""
from __future__ import annotations

import collections
import dataclasses
import functools

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import ieee_f32
from repro_torch.faults import plan as _faults

from .psram import PsramArray, PsramConfig
from .quantization import ADCConfig, QMAX, adc_requantize, quantize_symmetric


# ---------------------------------------------------------------------------
# IR
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StoreTile:
    """Program one weight tile into the array.

    Costs ``rows_written`` write cycles (one word-line latch per cycle at the
    20 GHz clock, §III-B). ``live_words`` is how many of the array's words
    hold live operands afterwards — the fill term of §V's utilization.
    ``(k0, k1, n0, n1)`` is the stored slice of the weight operand; programs
    built for accounting only (paper-scale MTTKRP) keep the default geometry.
    """

    rows_written: int
    live_words: int
    k0: int = 0
    k1: int = 0
    n0: int = 0
    n1: int = 0


@dataclasses.dataclass(frozen=True)
class Drive:
    """Issue ``cycles`` identical optical cycles against the stored tile.

    Each cycle occupies ``channels`` WDM channels and retires
    ``channels * live_words`` MACs (every live word MACs once per channel per
    cycle, §IV-A). ``(m0, m1)`` is the slice of drive vectors for executable
    matmul programs — one vector per channel, hyperspectral batching.
    """

    cycles: int
    channels: int
    live_words: int
    m0: int = 0
    m1: int = 0

    @property
    def macs(self) -> int:
        return self.cycles * self.channels * self.live_words


@dataclasses.dataclass(frozen=True)
class GatherDrive:
    """Drive per-output-row gather masks against a stored nonzero tile.

    The sparse-MTTKRP streaming schedule (repro_torch.sparse.stream): a tile
    holds one block of CP2 chain rows (one nonzero per word-line), and each
    optical cycle drives up to ``wavelengths`` binary gather masks — one per
    pending output-row *segment*, each on its own WDM channel — so the
    bit-lines perform CP3's segment sums and the per-channel ADC outputs
    accumulate electrically into their output rows.

    ``cycles``       optical cycles issued (⌈segments / channels⌉ batches).
    ``segments``     output-row segments served; each occupies one channel
                     for one cycle, so ``segments`` is this op's
                     channel-cycle occupancy.
    ``live_words``   stored words in the tile (block_nnz × rank-tile width).
    ``active_words`` mask-selected word-MACs over all cycles. Every stored
                     nonzero belongs to exactly one segment, so this equals
                     ``live_words`` when all segments are driven — unlike
                     :class:`Drive`, a word MACs on *one* channel, not all.
    """

    cycles: int
    segments: int
    live_words: int
    active_words: int

    @property
    def macs(self) -> int:
        return self.active_words


@dataclasses.dataclass(frozen=True)
class TileProgram:
    """A schedule: ops in issue order, repeated ``repeats`` times.

    ``shape`` is ``(M, K, N)`` for executable matmul programs (None for
    accounting-only programs, which :func:`execute` rejects).
    """

    config: PsramConfig
    ops: tuple
    repeats: int = 1
    shape: tuple[int, int, int] | None = None

    @property
    def executable(self) -> bool:
        return self.shape is not None and self.repeats == 1


@functools.lru_cache(maxsize=256)
def _canonical_matmul_program(m: int, k: int, n: int, cfg: PsramConfig) -> TileProgram:
    """The canonical §IV store/drive nest for one shape — built once per
    ``(shape, config)`` and shared (the program is a frozen dataclass tree).

    The cache keys by value, so equal configs share one program, and
    :func:`_validate_matmul_program` is an identity check against the cached
    ops tuple instead of a rebuild-and-compare.
    """
    ops = []
    for k0 in range(0, k, cfg.rows):
        k1 = min(k0 + cfg.rows, k)
        for n0 in range(0, n, cfg.word_cols):
            n1 = min(n0 + cfg.word_cols, n)
            live = (k1 - k0) * (n1 - n0)
            ops.append(StoreTile(rows_written=k1 - k0, live_words=live,
                                 k0=k0, k1=k1, n0=n0, n1=n1))
            for m0 in range(0, m, cfg.wavelengths):
                m1 = min(m0 + cfg.wavelengths, m)
                ops.append(Drive(cycles=1, channels=m1 - m0, live_words=live,
                                 m0=m0, m1=m1))
    return TileProgram(config=cfg, ops=tuple(ops), shape=(m, k, n))


def build_matmul_program(m: int, k: int, n: int, config: PsramConfig | None = None) -> TileProgram:
    """Schedule ``(M,K) @ (K,N)`` over array cycles — the §IV dense mapping.

    Loop nest (weights stationary, §IV-A): for each (K-tile, N-tile) the
    weight block is written once, then up to ``wavelengths`` rows of the
    input ride the array per optical cycle on distinct channels.

    Programs are cached per ``(shape, config)`` — equal configs (by value)
    hit the same entry and callers share one frozen program object.
    """
    from repro_torch.backends.base import resolve_config

    cfg = resolve_config(config)
    if m < 1 or k < 1 or n < 1:
        raise ValueError(f"degenerate matmul {m}x{k}x{n}")
    return _canonical_matmul_program(m, k, n, cfg)


def program_cache_stats():
    """(hits, misses, maxsize, currsize) of the canonical-program cache."""
    return _canonical_matmul_program.cache_info()


def clear_program_cache() -> None:
    """Drop cached canonical programs and compiled executors — releasing
    every captured CUDA graph and its private pool — and the kernel family's
    keyed caches beside them (the stored matmul weights of ``kernels.ops``,
    the stream kernel's quantized factors, the autotuned winners), so one
    call resets every keyed cache of the port."""
    from repro_torch.kernels import ops, stream_mttkrp
    from repro_torch.kernels.autotune import clear_autotune_cache

    _canonical_matmul_program.cache_clear()
    for executor, device in list(_CAPTURED):
        executor._drop(device)
    compiled_matmul_executor.cache_clear()
    ops.clear_store_cache()
    stream_mttkrp.clear_factor_quant_cache()
    clear_autotune_cache()


def stream_block_layout(fiber_lengths, rows: int):
    """Per-block nonzero counts and segment counts of a sorted nonzero
    stream — the layout both the sparse streaming scheduler
    (``repro_torch.sparse.stream.build_stream_program``) and the sparse
    analytical model (``perf_model.sustained_sparse_mttkrp``) are defined over.

    Blocks are ``rows`` consecutive nonzeros (the last one ragged); a fiber
    spanning blocks ``b0..b1`` contributes one output-row segment to each.
    Returns ``(nnz_per_block, segments_per_block)`` as int64 numpy arrays.
    """
    f = np.asarray(fiber_lengths, dtype=np.int64)
    f = f[f > 0]
    nnz = int(f.sum())
    if nnz == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    n_blocks = -(-nnz // rows)
    nnz_b = np.full(n_blocks, rows, dtype=np.int64)
    nnz_b[-1] = nnz - rows * (n_blocks - 1)
    ends = np.cumsum(f)
    starts = ends - f
    b0 = starts // rows
    b1 = (ends - 1) // rows
    # interval add: fiber i puts one segment in every block of [b0, b1]
    delta = np.zeros(n_blocks + 1, dtype=np.int64)
    np.add.at(delta, b0, 1)
    np.add.at(delta, b1 + 1, -1)
    return nnz_b, np.cumsum(delta)[:n_blocks]


def build_mttkrp_program(cfg: PsramConfig, wl) -> TileProgram:
    """Schedule the paper's §V MTTKRP mapping, for accounting.

    One tile window (Figs. 3-4): factor rows interleave down the columns —
    ``floor(rows/R)`` rank-R segments pack per column (§V's fill term); the
    tile is reused for ``k // wavelengths`` optical cycles before the next
    rewrite (§V's reconfiguration term); each cycle occupies one channel per
    pending (j,k) chain (§V's occupancy term). The window repeats until all
    ``wl.macs`` MACs are retired. ``wl`` is a
    :class:`~repro_torch.core.perf_model.MTTKRPWorkload`.
    """
    cfg.validate()
    rank_rows = min(wl.rank, cfg.rows)
    packed = max(1, cfg.rows // rank_rows)
    live = packed * rank_rows * cfg.word_cols
    reuse = max(1, wl.k // cfg.wavelengths)
    pending = max(1, wl.nonzeros // max(1, wl.i))
    channels = min(cfg.wavelengths, pending)
    window = (
        StoreTile(rows_written=cfg.rows, live_words=live),
        Drive(cycles=reuse, channels=channels, live_words=live),
    )
    macs_per_window = window[1].macs
    windows = max(1, -(-wl.macs // macs_per_window))  # ceil
    return TileProgram(config=cfg, ops=window, repeats=windows)


# ---------------------------------------------------------------------------
# accountant
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CycleCounts:
    """Counted resources of a program, in units of the array clock."""

    write_cycles: int
    compute_cycles: int
    macs: int
    channel_cycles: int    # sum over compute cycles of channels occupied
    live_word_cycles: int  # sum over compute cycles of live words MACing
    stores: int

    @property
    def total_cycles(self) -> int:
        return self.write_cycles + self.compute_cycles

    def __add__(self, other: "CycleCounts") -> "CycleCounts":
        return CycleCounts(
            self.write_cycles + other.write_cycles,
            self.compute_cycles + other.compute_cycles,
            self.macs + other.macs,
            self.channel_cycles + other.channel_cycles,
            self.live_word_cycles + other.live_word_cycles,
            self.stores + other.stores,
        )

    def reconfig_efficiency(self) -> float:
        return self.compute_cycles / max(1, self.total_cycles)

    def wavelength_occupancy(self, cfg: PsramConfig) -> float:
        return self.channel_cycles / max(1, cfg.wavelengths * self.compute_cycles)

    def fill_utilization(self, cfg: PsramConfig) -> float:
        return self.live_word_cycles / max(1, cfg.words * self.compute_cycles)

    def utilization(self, cfg: PsramConfig) -> float:
        """MACs retired / MACs the array could retire in the counted time."""
        return self.macs / max(1, cfg.words * cfg.wavelengths * self.total_cycles)

    def duration_s(self, cfg: PsramConfig) -> float:
        return self.total_cycles / (cfg.frequency_ghz * 1e9)


def count_cycles(program: TileProgram) -> CycleCounts:
    """Walk the program and count compute vs. write cycles and occupancies."""
    write = compute = macs = chan_cyc = live_cyc = stores = 0
    for op in program.ops:
        if isinstance(op, StoreTile):
            write += op.rows_written
            stores += 1
        elif isinstance(op, Drive):
            compute += op.cycles
            macs += op.macs
            chan_cyc += op.cycles * op.channels
            live_cyc += op.cycles * op.live_words
        elif isinstance(op, GatherDrive):
            compute += op.cycles
            macs += op.macs
            chan_cyc += op.segments
            live_cyc += op.cycles * op.live_words
        else:
            raise TypeError(f"unknown op {op!r}")
    r = program.repeats
    return CycleCounts(write * r, compute * r, macs * r,
                       chan_cyc * r, live_cyc * r, stores * r)


def program_energy(program: TileProgram, spec=None):
    """Map counted cycles onto per-device energies (§III-B) — feeds EnergySpec.

    Write energy charges every latched bit; static power and the laser run
    for the program's full duration (compute + write cycles); modulation
    charges 8 bits per word-line per occupied channel-cycle; the ADC converts
    one (column, wavelength) accumulation per occupied channel-cycle.
    """
    from .perf_model import EnergyBreakdown, EnergySpec
    spec = spec or EnergySpec()
    cfg = program.config
    counts = count_cycles(program)
    t = counts.duration_s(cfg)
    write_j = counts.write_cycles * cfg.bits_per_row * spec.write_pj_per_bit * 1e-12
    static_j = cfg.rows * cfg.bits_per_row * spec.static_aj_per_bit * 1e-18 \
        * counts.total_cycles
    modulate_j = counts.channel_cycles * cfg.rows * 8 * spec.modulator_fj_per_bit * 1e-15
    adc_j = counts.channel_cycles * cfg.word_cols * spec.adc_pj_per_conversion * 1e-12
    laser_j = spec.laser_wall_w * t
    return EnergyBreakdown(write_j, static_j, modulate_j, adc_j, laser_j)


# ---------------------------------------------------------------------------
# reference interpreter — per-cycle array physics
# ---------------------------------------------------------------------------

def _check_operands(program: TileProgram, x: torch.Tensor, w: torch.Tensor) -> None:
    if tuple(x.shape) != program.shape[:2] or tuple(w.shape) != program.shape[1:]:
        raise ValueError(f"operands {tuple(x.shape)}@{tuple(w.shape)} don't match program "
                         f"{program.shape}")


def execute_reference(program: TileProgram, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Interpret the program op by op through :class:`PsramArray`.

    Every StoreTile programs the array, every Drive issues one WDM-batched
    optical cycle, on ``x``'s device. Slow (a handful of launches and a host
    read of the channels per op) but each step is §III physics; the
    vectorized :func:`execute` is bit-identical to this.
    """
    _require_executable(program)
    _check_operands(program, x, w)
    cfg = program.config
    m, k, n = program.shape
    dev = x.device
    with obs.span("schedule/execute/reference", m=m, k=k, n=n,
                  ops=len(program.ops)):
        if obs.enabled():
            obs.counter("schedule/reference_ops", len(program.ops))
        out = torch.zeros((m, n), dtype=torch.float32, device=dev)
        arr = PsramArray(cfg, device=dev)
        tile = None
        cur = None
        for op in program.ops:
            if isinstance(op, StoreTile):
                cur = op
                tile = arr.store(w[op.k0:op.k1, op.n0:op.n1])
            else:
                xt = torch.zeros((op.m1 - op.m0, cfg.rows), dtype=torch.float32, device=dev)
                xt[:, : cur.k1 - cur.k0] = x[op.m0:op.m1, cur.k0:cur.k1]
                chan = torch.arange(op.m1 - op.m0, dtype=torch.int64, device=dev)
                acc = tile.multiply_accumulate(xt, chan)  # (cols, wavelengths)
                out[op.m0:op.m1, cur.n0:cur.n1] += acc[: cur.n1 - cur.n0, : op.m1 - op.m0].T
        return out


# ---------------------------------------------------------------------------
# vectorized executor
# ---------------------------------------------------------------------------

def _require_executable(program: TileProgram) -> None:
    if program.shape is None:
        raise ValueError("program carries no matmul geometry (accounting-only)")
    if program.repeats != 1:
        raise ValueError(
            f"program has repeats={program.repeats}; only single-pass programs "
            "are executable (repeated programs are for accounting)"
        )


def _validate_matmul_program(program: TileProgram) -> None:
    """Verify the ops ARE the canonical store/drive nest, geometry included.

    The vectorized lowering computes the canonical schedule for
    ``program.shape``; a reordered or re-sliced op sequence must raise here
    rather than silently executing a schedule the program doesn't describe
    (``execute_reference`` would honor the actual ops and disagree).
    Programs built by :func:`build_matmul_program` share the cached
    canonical ops tuple, so the check is an identity test; only a
    hand-assembled program pays the structural comparison.
    """
    m, k, n = program.shape
    expected = _canonical_matmul_program(m, k, n, program.config).ops
    if program.ops is expected:
        return
    if program.ops != expected:
        raise ValueError(
            f"non-canonical matmul program for shape {program.shape}: op "
            "sequence differs from the canonical store/drive nest — use "
            "execute_reference for custom schedules"
        )


# bytes the lhs, rhs and accumulator stacks of one chunk of K-tiles may take;
# the ADC's and the dequant's temporaries add a few times the accumulator's
_CHUNK_BYTES = 1 << 28


def _chunking(rows: int, cols: int, cells: int, kt: int, nt: int) -> tuple[int, int]:
    """``(kc, nb)``: K-tiles a chunk and N-tiles a block, so that one
    chunk's stacks take at most ``_CHUNK_BYTES`` (one K-tile of one N-tile
    at the least). ``cells`` is the padded M (``mt * wavelengths``)."""
    lhs = 4 * cells * rows                    # one K-tile's drive codes
    per_n = 4 * (rows + cells) * cols         # its stored codes and accumulator, an N-tile
    nb = nt
    if lhs + per_n * nt > _CHUNK_BYTES:
        nb = max(1, min(nt, (_CHUNK_BYTES - lhs) // per_n))
    kc = max(1, min(kt, _CHUNK_BYTES // (lhs + per_n * nb)))
    return kc, nb


class _FaultSites:
    """The armed plan's fault sites over one call's whole tile stack.

    The reference draws each mask once over the whole stack — stuck cells
    over the stored words ``(kt, nt, rows, cols)``, spikes over the analog
    accumulation ``(kt, mt, nt, wav, cols)`` — from ``faults.plan``'s seeded
    streams. The chunked executor draws them the same way, once a call, on
    the host, and hands each chunk of K-tiles and block of N-tiles its slice
    (:meth:`stored`, :meth:`analog`), so every fault lands on the
    reference's cell whatever the chunking. The masks take one byte a cell
    on the device; the draw takes eight a cell on the host while it runs.
    """

    def __init__(self, plan, *, rows, cols, wav, kt, nt, mt, device):
        self.plan = plan
        self.full_scale = float(QMAX) * float(QMAX) * rows

        def mask(key, shape, rate):
            drawn = _faults._rng(plan, *key).random(shape) < rate
            return torch.from_numpy(drawn).to(device) if drawn.any() else None

        self.stuck = [(f, mask((1, i), (kt, nt, rows, cols), f.rate))
                      for i, f in enumerate(plan.stuck_bits)]
        self.spikes = [(f, mask((2, i, _faults._EPOCH if f.transient else 0),
                                (kt, mt, nt, wav, cols), f.rate))
                       for i, f in enumerate(plan.adc_spikes)]

    def stored(self, qw: torch.Tensor, t0: int, j0: int) -> torch.Tensor:
        """``faults.plan.corrupt_stored`` on the chunk's words ``(kc, nb,
        rows, cols)`` at K-tile ``t0``, N-tile ``j0``: int32."""
        q = qw.to(torch.int32)
        if not self.stuck:
            return q
        sign = torch.where(q < 0, -1, 1).to(torch.int32)
        mag = q.abs()
        for f, m in self.stuck:
            if m is None:
                continue
            m = m[t0:t0 + q.shape[0], j0:j0 + q.shape[1]]
            bit = 1 << f.bit
            mag = torch.where(m, mag | bit, mag) if f.value else torch.where(m, mag & ~bit, mag)
        return sign * mag

    def analog(self, acc: torch.Tensor, t0: int, j0: int) -> torch.Tensor:
        """``faults.plan.corrupt_analog`` on the chunk's accumulation in the
        port's layout ``(kc, mt, wav, nb, cols)`` (the reference's is ``(kt,
        mt, nt, wav, cols)``, its channel axis 3): drift, dead channels,
        spikes, in float64 as there, returned as float32."""
        plan = self.plan
        a = acc.to(torch.float64)
        if plan.laser_drift is not None:
            a = a * plan.laser_drift.gain
        wav = a.shape[2]
        for dc in plan.dead_channels:
            live = [c for c in dc.channels if c < wav]
            if live:
                a[:, :, live] = 0.0
        kc, nb = a.shape[0], a.shape[3]
        for f, m in self.spikes:
            if m is None:
                continue
            m = m[t0:t0 + kc, :, j0:j0 + nb].permute(0, 1, 3, 2, 4)
            a = a + m.to(torch.float64) * (f.magnitude * self.full_scale)
        return a.to(torch.float32)


def _tile_values(xc, wc, *, rows, cols, wav, mt, kt, nt, adc, ctype, sites=None, at=(0, 0)):
    """Every optical cycle of ``kt`` K-tiles x ``nt`` N-tiles, digitized and
    dequantized: ``(kt, mt, wav, nt, cols)`` float32, the terms the K-tile
    fold adds. ``xc`` is ``(m, <= kt * rows)``, ``wc`` ``(<= kt * rows,
    <= nt * cols)``; both are zero-padded to whole tiles here.

    Numerics mirror ``PsramArray.store`` + the WDM-batched
    ``multiply_accumulate`` exactly: per-tile per-column weight scales,
    per-drive-vector intensity scales, the ADC at the array's fixed full
    scale ``QMAX^2 * rows`` (a ragged last K-tile included), the dequant
    scale formed as ``sx * sw`` before it multiplies the codes. ``sites``
    (a :class:`_FaultSites`, the chunk at K-tile, N-tile ``at``) corrupts
    the stored words and the analog accumulation as the reference's hooks
    do; the ADC then reads the float32 the corruption returns.
    """
    m, kx = xc.shape
    kw, nw = wc.shape
    xp = torch.nn.functional.pad(xc.to(torch.float32), (0, kt * rows - kx, 0, mt * wav - m))
    wp = torch.nn.functional.pad(wc.to(torch.float32), (0, nt * cols - nw, 0, kt * rows - kw))
    # stacked StoreTiles: quantize each (rows, cols) tile per column, exactly
    # as store() does (the bit-plane round trip is the identity on int8)
    wt = wp.reshape(kt, rows, nt, cols).permute(0, 2, 1, 3)      # (kt,nt,rows,cols)
    qw, sw = quantize_symmetric(wt, axis=2)                       # sw (kt,nt,1,cols)
    if sites is not None:       # stuck cells corrupt the words as stored
        qw = sites.stored(qw, *at)
    # stacked Drives: quantize each chunk's vectors per row over the K-tile
    xt = xp.reshape(mt, wav, kt, rows).permute(0, 2, 1, 3)       # (mt,kt,wav,rows)
    qx, sx = quantize_symmetric(xt, axis=3)                       # sx (mt,kt,wav,1)
    lhs = qx.to(ctype).permute(1, 0, 2, 3).reshape(kt, mt * wav, rows)
    rhs = qw.to(ctype).permute(0, 2, 1, 3).reshape(kt, rows, nt * cols)
    del qx, qw
    # one optical cycle per (m-chunk, k-tile, n-tile): exact bit-line sums
    acc = torch.bmm(lhs, rhs).view(kt, mt, wav, nt, cols)
    del lhs, rhs
    if sites is not None:       # drive-path faults on the analog accumulation, pre-ADC
        acc = sites.analog(acc, *at)
    acc = adc_requantize(acc, adc, float(QMAX) * float(QMAX) * rows)
    scale = sx.permute(1, 0, 2, 3)[..., None] * sw.permute(0, 2, 1, 3)[:, None]
    return acc.mul_(scale)                                        # (kt,mt,wav,nt,cols)


@ieee_f32()
def _execute_tiles(x, w, *, rows, cols, wav, kt, nt, mt, adc_bits, saturate):
    """All tile cycles of the canonical matmul schedule, batched, in chunks.

    The contraction is exact: every partial sum is an integer bounded by
    ``QMAX^2 * rows``, so while that fits float32's 2^24 integer range the
    batched product runs in float32 (with TF32 off: ``ieee_f32``), else in
    float64, which holds far larger integers exactly — the same integers the
    reference's int32 contraction gives. The K-tiles fold in schedule order
    (``out = vals[0]; out = out + vals[i]``), the fold carried across
    chunks, so the float adds happen in the sequence of the per-cycle
    reference's ``out +=``; a reordered sum (``vals.sum(0)``) would change
    bits. While a plan that touches the array path is armed, its sites are
    drawn once over the whole stack (:class:`_FaultSites`) and each chunk
    takes its slice.
    """
    m, k = x.shape
    n = w.shape[1]
    cells = mt * wav
    ctype = torch.float32 if float(QMAX) * float(QMAX) * rows < 2 ** 24 else torch.float64
    adc = ADCConfig(bits=adc_bits, saturate=saturate)
    plan = _faults._ACTIVE
    sites = None
    if plan is not None and plan.touches_array_path:
        sites = _FaultSites(plan, rows=rows, cols=cols, wav=wav, kt=kt, nt=nt, mt=mt,
                            device=x.device)
    kc, nb = _chunking(rows, cols, cells, kt, nt)
    blocks = []
    for j0 in range(0, nt, nb):
        j1 = min(j0 + nb, nt)
        out = None
        for t0 in range(0, kt, kc):
            t1 = min(t0 + kc, kt)
            vals = _tile_values(x[:, t0 * rows:t1 * rows], w[t0 * rows:t1 * rows,
                                                             j0 * cols:j1 * cols],
                                rows=rows, cols=cols, wav=wav, mt=mt, kt=t1 - t0,
                                nt=j1 - j0, adc=adc, ctype=ctype, sites=sites, at=(t0, j0))
            for i in range(t1 - t0):
                out = vals[i].clone() if out is None else out.add_(vals[i])
            del vals
        blocks.append(out.reshape(cells, (j1 - j0) * cols))
    out = blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)
    return out[:m, :n].contiguous()


def _tile_geometry(m: int, k: int, n: int, cfg: PsramConfig) -> dict:
    return dict(rows=cfg.rows, cols=cfg.word_cols, wav=cfg.wavelengths,
                kt=-(-k // cfg.rows), nt=-(-n // cfg.word_cols), mt=-(-m // cfg.wavelengths),
                adc_bits=cfg.adc.bits, saturate=cfg.adc.saturate)


# card memory the captured graphs may hold together on one device (their
# private pools and static operands); past it the least recently replayed
# are released, and captured again on their next call
_GRAPH_BYTES = 1 << 31

# (executor, device) -> the bytes its graph holds, least recently replayed first
_CAPTURED: "collections.OrderedDict[tuple[_GraphedExecutor, torch.device], int]" = \
    collections.OrderedDict()

# device -> the one stream every capture on it runs on
_CAPTURE_STREAMS: dict = {}


def captured_graphs() -> list[tuple[tuple[int, int, int], torch.device, int]]:
    """``(shape, device, bytes)`` of every captured graph the compiled
    executors hold, least recently replayed first."""
    return [(ex._shape, dev, nbytes) for (ex, dev), nbytes in _CAPTURED.items()]


def _evict(device: torch.device, keep: "_GraphedExecutor") -> None:
    """Release the least recently replayed graphs on ``device`` until those
    left hold at most ``_GRAPH_BYTES``; ``keep``'s graph always stays."""
    held = sum(nbytes for (_, dev), nbytes in _CAPTURED.items() if dev == device)
    for executor, dev in list(_CAPTURED):
        if held <= _GRAPH_BYTES:
            return
        if dev == device and executor is not keep:
            held -= _CAPTURED[(executor, dev)]
            executor._drop(dev)


class _GraphedExecutor:
    """``fn(x, w)`` for one ``(M, K, N)``: the eager executor captured in a
    CUDA graph per CUDA device on its first call there, then replayed.

    A call with a CUDA tensor copies the operands into the graph's static
    inputs, replays, and returns a copy of the static output; the working
    set lives in the graph's private memory pool until the graph is
    released (:meth:`release`, :func:`clear_program_cache`, or the byte
    budget ``_GRAPH_BYTES`` shared by every executor). A call with a CPU
    tensor, or any call while a fault plan is armed, runs the eager
    executor: a graph would bake one draw of the faults into its replays. A
    capture that fails raises; nothing else falls back to eager on the card.
    """

    def __init__(self, fn, shape: tuple[int, int, int]):
        self._fn = fn
        self._shape = shape
        self._graphs: dict = {}

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if x.device.type != "cuda" or _faults._ACTIVE is not None:
            return self._fn(x, w)
        entry = self._graphs.get(x.device)
        if entry is None:
            entry = self._graphs[x.device] = self._capture(x.device)
            _evict(x.device, keep=self)
        else:
            _CAPTURED.move_to_end((self, x.device))
        graph, static_x, static_w, static_out = entry
        static_x.copy_(x)
        static_w.copy_(w)
        graph.replay()
        return static_out.clone()

    def _capture(self, device: torch.device):
        m, k, n = self._shape
        static_x = torch.zeros((m, k), dtype=torch.float32, device=device)
        static_w = torch.zeros((k, n), dtype=torch.float32, device=device)
        # one capture stream a device for every executor: the library keeps
        # a workspace for each stream it has run on, so a new stream per
        # capture would leave one behind each time
        stream = _CAPTURE_STREAMS.get(device)
        if stream is None:
            stream = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
        with torch.cuda.device(device):
            # a first run off the capture: library handles and workspaces
            # exist before the graph records
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                self._fn(static_x, static_w)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                static_out = self._fn(static_x, static_w)
        pool = tuple(graph.pool())
        held = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool)
        _CAPTURED[(self, device)] = held + static_x.nbytes + static_w.nbytes
        return graph, static_x, static_w, static_out

    def _drop(self, device: torch.device) -> None:
        entry = self._graphs.pop(device, None)
        _CAPTURED.pop((self, device), None)
        if entry is not None:
            entry[0].reset()

    def release(self) -> None:
        """Drop every captured graph, its static tensors and its pool."""
        for device in list(self._graphs):
            self._drop(device)


@functools.lru_cache(maxsize=128)
def compiled_matmul_executor(m: int, k: int, n: int, cfg: PsramConfig):
    """The compiled executor for one ``(shape, config)``: ``fn(x, w)``.

    Cached so equal-by-value configs return the *identical* callable (and
    with it the captured CUDA graph, while the graphs' byte budget keeps
    it). On the card the replay runs the eager
    executor's kernels, so it gives the eager bits; the capabilities keep
    the reference's looser contract (``bit_exact=False``, ~1e-7 relative
    against the eager executor), and :func:`execute` with ``compiled=False``
    (the default) stays the bit-identity oracle against
    :func:`execute_reference`.
    """
    return _GraphedExecutor(functools.partial(_execute_tiles, **_tile_geometry(m, k, n, cfg)),
                            (m, k, n))


def execute(program: TileProgram, x: torch.Tensor, w: torch.Tensor,
            compiled: bool = False) -> torch.Tensor:
    """Run an executable matmul program on the vectorized executor, on
    ``x``'s device.

    Bit-identical to :func:`execute_reference` on every shape: one batched
    contraction per chunk of K-tiles over the padded tile stacks instead of
    a store and a drive dispatch per tile.

    ``compiled=True`` runs the cached compiled executor for the program's
    ``(shape, config)`` instead (:func:`compiled_matmul_executor`: a CUDA
    graph replay on the card, the eager executor on the CPU and while a
    fault plan is armed, as the reference falls back to its eager executor).
    """
    _require_executable(program)
    _validate_matmul_program(program)
    _check_operands(program, x, w)
    m, k, n = program.shape
    with obs.span("schedule/execute/matmul", m=m, k=k, n=n,
                  compiled=compiled):
        if obs.enabled():
            obs.counter("schedule/programs_executed")
        if compiled:
            return compiled_matmul_executor(m, k, n, program.config)(x, w)
        return _execute_tiles(x, w, **_tile_geometry(m, k, n, program.config))
