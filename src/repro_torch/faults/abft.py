"""Algorithm-based fault tolerance: checksum detect → locate → re-drive.

Two front doors, one per executable workload family:

* :func:`abft_matmul` — **checksum-extended factors** (Huang & Abraham):
  one extra weight column per N-tile holds that tile's column sum and rides
  the SAME array schedule as the data, so ``sum_n y[m, tile] ≈ c[m, tile]``
  within the ADC envelope. A violation localizes the corruption to an
  (output row, N-tile) site; the flagged tiles are re-driven.
* :func:`abft_mttkrp` — **output-row checksums**: root fibers are grouped
  into contiguous ranges and each group's exact row-sum (the CP2 chain in
  plain f32 — the integrity reference, cheap next to the streamed drive) is
  compared against the group's summed pSRAM output rows. A violating group
  localizes to a fiber range, which ``CSF.slice_roots`` re-drives.

The detection threshold is *calibrated, not guessed*: per site it is

    rel_tol * (noise scale of the site + |checksum|) + atol floor

with ``rel_tol`` defaulting to the executing backend's documented
``Capabilities.rel_tol`` (the ADC envelope every lossy backend already
promises, 0.05 on the §V-A config). The noise scale is the row's L2 norm
for matmul tiles (independent per-column quantization errors concentrate
like ``sqrt(T)``; an L1 scale would dilute single-word faults by the tile
width) and the group's L1 magnitude sum for MTTKRP fiber groups (the
per-nonzero errors are relative to block maxima, so the conservative
bound keeps the margin). Pure ADC/quantization noise sits well below both
thresholds, while a stuck MSB or a multi-LSB spike lands far above them.

Recovery is bounded retry with exponential backoff, priced in the cycle
domain: every re-drive attempt bills its tile/fiber-range program through
``count_cycles`` (the accountant) plus ``backoff_cycles * 2**attempt``, and
the total lands in :class:`AbftReport` (seconds via the array clock). A
persistent fault (stuck cells recur on every retry) exhausts the retries
and falls back to a fault-suppressed re-drive — the spare-hardware path —
recorded as ``fallbacks`` rather than silently succeeding.

The drives run on the operands' device: the matmul on the scheduled
executor (``core.schedule.execute``), the MTTKRP's check on the mesh stream
(``sparse.mesh.mesh_stream_mttkrp``) and its re-drives on the single-array
stream (``sparse.stream.stream_mttkrp``). The thresholds and the checksum
comparisons run in numpy on host copies, in the reference's order, so the
flagged sites are the reference's for the same operands. The MTTKRP's
exact group checksums are sequential sums in stream order (the reference's
``np.add.at``) formed on the operands' device by ``kernels.ordered_fold``
(its fold route on the card, ``index_add_`` on the CPU). ``y`` comes back
as a tensor on the operands' device.
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
class AbftConfig:
    """Detection/recovery knobs.

    ``rel_tol=None`` reads the executing backend's ``Capabilities.rel_tol``
    — the one documented ADC envelope — so ABFT and the registry can never
    disagree about what "within tolerance" means.
    """

    rel_tol: float | None = None
    atol: float = 1e-6            # absolute floor, scaled by the output range
    max_retries: int = 3
    backoff_cycles: int = 256     # recovery bill: backoff_cycles * 2**attempt

    def validate(self) -> None:
        if self.rel_tol is not None and not 0.0 < self.rel_tol < 1.0:
            raise ValueError(f"rel_tol {self.rel_tol} outside (0, 1)")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")


@dataclasses.dataclass
class AbftReport:
    """What one checked execution saw and paid."""

    checked: int                  # checksum sites examined
    detected: list                # flagged site ids (n-tile / fiber-group)
    retries: int = 0              # re-drive attempts issued
    recovered: int = 0            # sites that passed after a re-drive
    fallbacks: int = 0            # sites recomputed fault-suppressed
    redrive_cycles: int = 0       # counted cycles of every re-drive program
    backoff_cycles: int = 0       # priced retry backoff
    checksum_cycles: int = 0      # detection overhead (checksum drive)
    rel_tol: float = 0.0          # the calibrated threshold actually used

    @property
    def faulty(self) -> bool:
        return bool(self.detected)

    @property
    def recovery_cycles(self) -> int:
        return self.redrive_cycles + self.backoff_cycles

    def recovery_s(self, config: PsramConfig) -> float:
        return self.recovery_cycles / (config.frequency_ghz * 1e9)


def _cap_rel_tol(backend_name: str, cfg) -> float:
    from repro_torch import backends

    return backends.get(backend_name, cfg).capabilities().rel_tol


def _host(t: torch.Tensor) -> np.ndarray:
    """A writable host copy of ``t``."""
    return np.array(t.detach().cpu().numpy())


# ---------------------------------------------------------------------------
# matmul: checksum-extended factors
# ---------------------------------------------------------------------------

def _tile_checksums(w: np.ndarray, cols: int) -> np.ndarray:
    """(K, n_tiles) checksum factor: column sums per N-tile of ``w``."""
    k, n = w.shape
    nt = -(-n // cols)
    wc = np.zeros((k, nt), dtype=np.float32)
    for t in range(nt):
        wc[:, t] = w[:, t * cols:(t + 1) * cols].sum(axis=1)
    return wc


def abft_matmul(x, w, config: PsramConfig | None = None,
                abft: AbftConfig | None = None,
                backend: str = "psram-scheduled"):
    """``x @ w`` on the scheduled pSRAM executor with ABFT around it, on
    ``x``'s device.

    Returns ``(y, AbftReport)``. The checksum columns run through
    :func:`~repro_torch.core.schedule.execute` exactly like the data (they
    see the same armed faults); flagged N-tiles are re-driven with bounded
    retry + backoff and, when the fault is persistent, a fault-suppressed
    fallback. ``y`` is the corrected output.
    """
    from repro_torch.core.schedule import build_matmul_program, count_cycles, execute

    cfg = resolve_config(config)
    abft = abft or AbftConfig()
    abft.validate()
    rel = abft.rel_tol if abft.rel_tol is not None \
        else _cap_rel_tol(backend, cfg)
    x = torch.as_tensor(x, dtype=torch.float32)
    w = torch.as_tensor(w, dtype=torch.float32, device=x.device)
    m, k = x.shape
    n = w.shape[1]
    cols = cfg.word_cols
    n_tiles = -(-n // cols)

    wc = torch.from_numpy(_tile_checksums(w.detach().cpu().numpy(), cols)).to(x.device)
    prog = build_matmul_program(m, k, n, cfg)
    prog_c = build_matmul_program(m, k, n_tiles, cfg)
    with obs.span("fault/abft/check", kind="matmul", m=m, k=k, n=n,
                  tiles=n_tiles):
        y = _host(execute(prog, x, w))
        c = _host(execute(prog_c, x, wc))
        report = AbftReport(checked=n_tiles, detected=[], rel_tol=rel,
                            checksum_cycles=count_cycles(prog_c).total_cycles)
        bad_tiles = _matmul_violations(y, c, cols, rel, abft.atol)
        report.detected = sorted(bad_tiles)
        if report.detected and obs.enabled():
            obs.counter("fault/detected", len(report.detected))

    prog_tile_c = build_matmul_program(m, k, 1, cfg)
    for t in report.detected:
        n0, n1 = t * cols, min((t + 1) * cols, n)
        prog_t = build_matmul_program(m, k, n1 - n0, cfg)
        tile_cycles = (count_cycles(prog_t).total_cycles
                       + count_cycles(prog_tile_c).total_cycles)
        ok = False
        for attempt in range(abft.max_retries):
            plan_mod.bump_epoch()
            with obs.span("fault/abft/redrive", kind="matmul", tile=t,
                          attempt=attempt):
                sub = _host(execute(prog_t, x, w[:, n0:n1]))
                sub_c = _host(execute(prog_tile_c, x, wc[:, t:t + 1]))
            report.retries += 1
            report.redrive_cycles += tile_cycles
            report.backoff_cycles += abft.backoff_cycles << attempt
            if obs.enabled():
                obs.counter("fault/redrives")
            if not _matmul_violations(sub, sub_c, cols, rel, abft.atol):
                y[:, n0:n1] = sub
                report.recovered += 1
                ok = True
                break
        if not ok:
            # persistent fault: the spare-hardware path (fault-suppressed)
            with plan_mod.suspended(), \
                    obs.span("fault/abft/fallback", kind="matmul", tile=t):
                y[:, n0:n1] = _host(execute(prog_t, x, w[:, n0:n1]))
            report.redrive_cycles += count_cycles(prog_t).total_cycles
            report.fallbacks += 1
        if obs.enabled():
            obs.counter("fault/recovered")
    if report.recovery_cycles and obs.enabled():
        obs.counter("fault/recovery_cycles", report.recovery_cycles)
    return torch.from_numpy(y).to(x.device), report


def _matmul_violations(y: np.ndarray, c: np.ndarray, cols: int,
                       rel: float, atol: float) -> set[int]:
    """N-tiles whose row sums disagree with their checksum column.

    The noise scale is the row's L2 norm, not its L1 bound: quantization
    errors across a tile's <= ``word_cols`` columns are independent and
    concentrate like ``sqrt(T)`` — which is exactly what the L2 norm
    carries — while a corrupted word shifts the sum by its full magnitude.
    ``rel * (L2 + |c|)`` therefore keeps the documented per-element
    envelope's false-positive headroom without diluting single-word faults
    by the tile width the way an L1 scale does.
    """
    m, n = y.shape
    nt = c.shape[1]
    bad: set[int] = set()
    floor = atol * max(1.0, float(np.max(np.abs(y)) if y.size else 1.0))
    for t in range(nt):
        tile = y[:, t * cols:min((t + 1) * cols, n)]
        s = tile.sum(axis=1)
        l2 = np.linalg.norm(tile, axis=1)
        tol = rel * (l2 + np.abs(c[:, t])) + floor
        if (np.abs(s - c[:, t]) > tol).any():
            bad.add(t)
    return bad


# ---------------------------------------------------------------------------
# MTTKRP: output-row checksums over fiber groups
# ---------------------------------------------------------------------------

def _fiber_groups(n_fibers: int, group_fibers: int) -> list[tuple[int, int]]:
    return [(g0, min(g0 + group_fibers, n_fibers))
            for g0 in range(0, n_fibers, group_fibers)]


def _group_reference(csf, factors, mode: int,
                     groups: list[tuple[int, int]]):
    """Exact per-group checksums + noise scales, f32, as host arrays.

    ``c[g, r] = sum over group-g nonzeros of val * prod factors`` — the
    CP2 chain without quantization — and ``l1[g, r]`` the matching sum of
    magnitudes (the scale ADC noise is proportional to). Each sum adds the
    group's nonzeros one at a time in stream order, from zero — the bits of
    the reference's ``np.add.at`` — through ``kernels.ordered_fold`` on the
    CSF's device.
    """
    from repro_torch.core.mttkrp import cp_chain_exact
    from repro_torch.kernels.ordered_fold import ordered_fold

    dev = csf.device
    scaled = cp_chain_exact(csf.expanded_indices(), csf.values,
                            tuple(f.to(dev) for f in factors), mode)
    # map each nonzero to its root-fiber group
    lengths = np.asarray(csf.fiber_lengths(), dtype=np.int64)
    fiber_of = np.repeat(np.arange(len(lengths)), lengths)
    bounds = np.asarray([g0 for g0, _ in groups] + [len(lengths)])
    group_of = torch.from_numpy(np.searchsorted(bounds, fiber_of, side="right") - 1).to(dev)
    g = len(groups)
    rank = scaled.shape[1]
    c = ordered_fold(torch.zeros((g, rank), dtype=torch.float32, device=dev),
                     scaled, group_of)
    l1 = ordered_fold(torch.zeros((g, rank), dtype=torch.float32, device=dev),
                      scaled.abs_(), group_of)
    return _host(c), _host(l1)


def _group_sums(y: np.ndarray, csf, groups) -> np.ndarray:
    rows = csf.fids[0]
    return np.stack([y[rows[g0:g1]].sum(axis=0) for g0, g1 in groups])


def _mttkrp_violations(y, csf, groups, c, l1, rel, atol) -> set[int]:
    s = _group_sums(y, csf, groups)
    floor = atol * max(1.0, float(np.max(np.abs(y)) if y.size else 1.0))
    tol = rel * (l1 + np.abs(c)) + floor
    return set(np.flatnonzero((np.abs(s - c) > tol).any(axis=1)).tolist())


def _spiked(csf_sub, plan):
    """The replacement drive sees the same transient-fault environment the
    per-shard mesh hook models: current-epoch seeded spikes on the stream."""
    if plan is None or not plan.adc_spikes:
        return csf_sub
    vals = plan_mod.corrupt_shard_values(
        dataclasses.replace(plan, array_loss=()), csf_sub.values[None])[0]
    # float32, as the reference's jnp.asarray makes the float64 sum
    return dataclasses.replace(csf_sub, values=torch.from_numpy(
        vals.astype(np.float32)).to(csf_sub.device))


def abft_mttkrp(tensor, factors, mode: int = 0,
                config: PsramConfig | None = None,
                abft: AbftConfig | None = None,
                n_arrays: int | None = 1,
                lowering: str = "eager",
                planner: str = "makespan",
                group_fibers: int | None = None,
                adc_bits: int = 16,
                backend: str = "psram-mesh"):
    """Sparse MTTKRP through the mesh stream with ABFT around it.

    ``tensor`` is a COO or a mode-rooted CSF. The streamed result's
    fiber-group row sums are checked against the exact CP2-chain checksums;
    flagged groups re-drive their ``slice_roots`` range (bounded retry with
    epoch-bumped transients, then the fault-suppressed fallback). Returns
    ``(y, AbftReport)`` with recovery priced through the stream accountant.
    """
    from repro_torch.core.schedule import count_cycles
    from repro_torch.sparse.formats import CSF, csf_for_mode
    from repro_torch.sparse.mesh import mesh_stream_mttkrp
    from repro_torch.sparse.stream import build_stream_program, stream_mttkrp

    cfg = resolve_config(config)
    abft = abft or AbftConfig()
    abft.validate()
    rel = abft.rel_tol if abft.rel_tol is not None \
        else _cap_rel_tol(backend, cfg)
    csf = tensor if isinstance(tensor, CSF) else csf_for_mode(tensor, mode)
    mode = csf.mode_order[0]
    factors = tuple(factors)
    rank = int(factors[0].shape[-1])
    nf = len(csf.fids[0])
    gf = group_fibers or max(1, -(-nf // 16))
    groups = _fiber_groups(nf, gf)

    with obs.span("fault/abft/check", kind="mttkrp", nnz=csf.nnz,
                  groups=len(groups)):
        y = _host(mesh_stream_mttkrp(
            csf, factors, cfg, n_arrays=n_arrays, adc_bits=adc_bits,
            lowering=lowering, planner=planner))
        c, l1 = _group_reference(csf, factors, mode, groups)
        report = AbftReport(checked=len(groups), detected=[], rel_tol=rel)
        report.detected = sorted(_mttkrp_violations(
            y, csf, groups, c, l1, rel, abft.atol))
        if report.detected and obs.enabled():
            obs.counter("fault/detected", len(report.detected))

    f_all = np.asarray(csf.fiber_lengths(), dtype=np.int64)
    plan = plan_mod.active()
    for g in report.detected:
        g0, g1 = groups[g]
        sub = csf.slice_roots(g0, g1)
        rows = sub.fids[0]
        sub_groups = [(0, len(rows))]
        sub_cycles = count_cycles(
            build_stream_program(f_all[g0:g1], rank, cfg)).total_cycles
        ok = False
        for attempt in range(abft.max_retries):
            plan_mod.bump_epoch()
            with obs.span("fault/abft/redrive", kind="mttkrp", group=g,
                          attempt=attempt):
                rec = _host(stream_mttkrp(
                    _spiked(sub, plan), factors, cfg, psram=True,
                    adc_bits=adc_bits))
            report.retries += 1
            report.redrive_cycles += sub_cycles
            report.backoff_cycles += abft.backoff_cycles << attempt
            if obs.enabled():
                obs.counter("fault/redrives")
            if not _mttkrp_violations(rec, sub, sub_groups,
                                      c[g:g + 1], l1[g:g + 1], rel,
                                      abft.atol):
                y[rows] = rec[rows]
                report.recovered += 1
                ok = True
                break
        if not ok:
            with plan_mod.suspended(), \
                    obs.span("fault/abft/fallback", kind="mttkrp", group=g):
                rec = _host(stream_mttkrp(sub, factors, cfg, psram=True,
                                          adc_bits=adc_bits))
            y[rows] = rec[rows]
            report.redrive_cycles += sub_cycles
            report.fallbacks += 1
        if obs.enabled():
            obs.counter("fault/recovered")
    if report.recovery_cycles and obs.enabled():
        obs.counter("fault/recovery_cycles", report.recovery_cycles)
    return torch.from_numpy(y).to(csf.device), report
