"""Seeded device-fault models for the pSRAM stack, and their injection runtime.

The port's copy of the reference's ``faults/plan.py``, whole: the fault
models, :class:`FaultPlan`, the injection runtime and the three corruption
transforms. The transforms draw their sites from the same seeded numpy
streams, so a plan corrupts the same slots in both packages; they take numpy
arrays or torch tensors (read on the host) and return numpy arrays, which
the caller puts back on its device.

Every fault the analog readout chain can realistically throw at the engine
is a frozen dataclass here, gathered into one :class:`FaultPlan`:

* :class:`StuckBit` — pSRAM bitcells whose magnitude bit latches at 0/1:
  stored tiles corrupt *persistently* (the same seeded sites every drive).
* :class:`AdcSpike` — transient photocurrent/ADC glitches: additive spikes
  on the analog accumulation of a ``Drive``/``GatherDrive``, re-rolled per
  *re-drive epoch* so a retry can clear them.
* :class:`DeadChannel` — WDM comb lines that carry no light: the channel's
  accumulations read zero.
* :class:`LaserDrift` — comb power drift: a multiplicative gain on every
  photocurrent before the ADC.
* :class:`ArrayLoss` — a whole array drops off the mesh: its shard
  contributes nothing to the sum of the partial outputs (degraded-mode
  control, ``faults.degraded``, re-plans around it).

Injection follows the obs null-span discipline: the executors read ONE
module global (:data:`_ACTIVE`) and branch — no allocation, no clock, no
call when no plan is armed — so the hot paths are exactly as fast as before
this module existed. Everything is seeded and wall-clock-free: fault sites come from
``np.random.default_rng`` streams keyed on ``(plan.seed, fault kind, fault
index, epoch)``, so a plan replays bit-identically across runs and hosts.

The mesh executor (``sparse.mesh``) applies the shard faults; the schedule
executor (``core.schedule``) applies the stuck bits and the drive-path
faults, its masks drawn from these streams over the reference's shapes.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.quantization import QMAX, WORD_BITS


# ---------------------------------------------------------------------------
# fault models
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StuckBit:
    """Stuck-at faults on stored magnitude bits (persistent).

    ``bit`` is the magnitude bit plane (0 = LSB .. ``WORD_BITS``-1 = MSB),
    ``value`` what it reads (0 or 1), ``rate`` the seeded Bernoulli fraction
    of stored words whose cell is defective. Sites are fixed per plan seed —
    a re-drive of the same tile sees the same stuck cells.
    """

    bit: int = WORD_BITS - 1
    value: int = 1
    rate: float = 1e-3

    def validate(self) -> None:
        if not 0 <= self.bit < WORD_BITS:
            raise ValueError(f"bit {self.bit} outside the {WORD_BITS}-bit word")
        if self.value not in (0, 1):
            raise ValueError(f"stuck value must be 0 or 1, got {self.value}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate {self.rate} outside [0, 1]")


@dataclasses.dataclass(frozen=True)
class AdcSpike:
    """Transient photocurrent/ADC glitches on drive accumulations.

    Each (tile, channel, column) accumulation is hit independently with
    probability ``rate``; a hit adds ``magnitude`` x the ADC full scale to
    the analog value before digitization. ``transient`` spikes re-roll their
    sites every re-drive epoch (:func:`bump_epoch`) — the fault model that
    makes bounded retry worthwhile; a non-transient spike recurs like a
    stuck cell.
    """

    magnitude: float = 0.25
    rate: float = 1e-3
    transient: bool = True

    def validate(self) -> None:
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate {self.rate} outside [0, 1]")
        if self.magnitude == 0.0:
            raise ValueError("a zero-magnitude spike is not a fault")


@dataclasses.dataclass(frozen=True)
class DeadChannel:
    """WDM channels that carry no light: their accumulations read zero."""

    channels: tuple[int, ...]

    def validate(self) -> None:
        if not self.channels:
            raise ValueError("DeadChannel needs at least one channel index")
        if any(c < 0 for c in self.channels):
            raise ValueError(f"negative channel index in {self.channels}")


@dataclasses.dataclass(frozen=True)
class LaserDrift:
    """Comb power drift: every photocurrent scales by ``gain`` before ADC."""

    gain: float = 0.97

    def validate(self) -> None:
        if not 0.0 < self.gain or self.gain == 1.0:
            raise ValueError(f"drift gain must be positive and != 1, got {self.gain}")


@dataclasses.dataclass(frozen=True)
class ArrayLoss:
    """A whole array drops off the mesh: its shard contributes nothing."""

    array_id: int

    def validate(self) -> None:
        if self.array_id < 0:
            raise ValueError(f"negative array id {self.array_id}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One seeded, replayable description of everything going wrong.

    Arm it with :func:`inject`; executors pick it up through their
    zero-cost hooks. A plan is inert data — building one costs nothing and
    touches no global state.
    """

    seed: int = 0
    stuck_bits: tuple[StuckBit, ...] = ()
    adc_spikes: tuple[AdcSpike, ...] = ()
    dead_channels: tuple[DeadChannel, ...] = ()
    laser_drift: LaserDrift | None = None
    array_loss: tuple[ArrayLoss, ...] = ()

    def validate(self) -> None:
        for f in (*self.stuck_bits, *self.adc_spikes, *self.dead_channels,
                  *self.array_loss):
            f.validate()
        if self.laser_drift is not None:
            self.laser_drift.validate()

    @property
    def dead_arrays(self) -> frozenset[int]:
        return frozenset(a.array_id for a in self.array_loss)

    @property
    def touches_array_path(self) -> bool:
        """Does this plan corrupt the single-array executor at all?"""
        return bool(self.stuck_bits or self.adc_spikes or self.dead_channels
                    or self.laser_drift is not None)


# ---------------------------------------------------------------------------
# injection runtime — the null-span pattern for faults
# ---------------------------------------------------------------------------

_ACTIVE: FaultPlan | None = None   # executors read this global and branch
_EPOCH: int = 0                    # re-drive epoch: transient faults re-roll


def active() -> FaultPlan | None:
    """The armed plan, or None. Hot paths read the module global directly
    (``plan_mod._ACTIVE``) — this accessor is for everyone else."""
    return _ACTIVE


def epoch() -> int:
    return _EPOCH


def bump_epoch() -> int:
    """Advance the re-drive epoch: transient fault sites re-roll. Called by
    the ABFT re-drive loop between attempts (a retry without a new epoch
    would replay the identical glitches and learn nothing)."""
    global _EPOCH
    _EPOCH += 1
    return _EPOCH


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """Arm ``plan`` for the dynamic extent of the block.

    Not reentrant — a nested injection would silently shadow the outer
    plan's seeds, so it raises instead. Epoch resets to 0 on entry; the
    armed plan is cleared even on exceptions.
    """
    global _ACTIVE, _EPOCH
    if _ACTIVE is not None:
        raise RuntimeError("a FaultPlan is already armed; nest injections "
                           "by composing one plan instead")
    plan.validate()
    _ACTIVE = plan
    _EPOCH = 0
    if obs.enabled():
        obs.counter("fault/injected")
    try:
        with obs.span("fault/inject/armed", seed=plan.seed,
                      stuck=len(plan.stuck_bits), spikes=len(plan.adc_spikes),
                      dead_channels=len(plan.dead_channels),
                      arrays_lost=len(plan.array_loss)):
            yield plan
    finally:
        _ACTIVE = None
        _EPOCH = 0


@contextlib.contextmanager
def suspended():
    """Temporarily disarm the active plan (the ABFT persistent-fault
    fallback: re-drive a tile on known-good spare hardware)."""
    global _ACTIVE
    saved, _ACTIVE = _ACTIVE, None
    try:
        yield
    finally:
        _ACTIVE = saved


# ---------------------------------------------------------------------------
# corruption transforms — called by the executors ONLY when a plan is armed
# ---------------------------------------------------------------------------

def _rng(plan: FaultPlan, *key: int) -> np.random.Generator:
    return np.random.default_rng([plan.seed & 0x7FFFFFFF, *key])


def _host(a) -> np.ndarray:
    """``a`` as a numpy array: a torch tensor (on any device) read back to
    the host, anything else through ``np.asarray``."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def corrupt_stored(plan: FaultPlan, qw) -> "np.ndarray":
    """Stuck-at bits applied to a stack of stored (quantized) weight tiles.

    ``qw`` is the signed int8 word stack (any shape). The stuck bit acts on
    the magnitude plane — exactly the cell
    :func:`~repro_torch.core.quantization.to_bitplanes` would have latched —
    with the sign rail untouched. Sites are persistent: the same seeded cells corrupt on every store of the
    same-shaped stack. Returns int32 (a stuck-at-1 MSB can push a word past
    the int8 range; the executor's contraction widens anyway).
    """
    q = _host(qw).astype(np.int32)
    if not plan.stuck_bits:
        return q
    sign = np.where(q < 0, -1, 1)
    # zero words keep sign +1: a stuck-at-1 cell makes them readable again,
    # which is the physical behavior (the rail default)
    mag = np.abs(q)
    for i, f in enumerate(plan.stuck_bits):
        mask = _rng(plan, 1, i).random(q.shape) < f.rate
        if f.value:
            mag = np.where(mask, mag | (1 << f.bit), mag)
        else:
            mag = np.where(mask, mag & ~(1 << f.bit), mag)
    return (sign * mag).astype(np.int32)


def corrupt_analog(plan: FaultPlan, acc, full_scale: float,
                   channel_axis: int):
    """Drive-path faults on the analog accumulation, pre-ADC.

    ``acc`` is the integer/float photocurrent stack; ``channel_axis`` is the
    WDM-channel axis (dead channels zero their slice). Order matches the
    physics: the laser drifts (gain on everything), dead channels never
    light up, then transient spikes land on whatever the detector sees.
    """
    a = _host(acc).astype(np.float64)
    if plan.laser_drift is not None:
        a = a * plan.laser_drift.gain
    if plan.dead_channels:
        wav = a.shape[channel_axis]
        idx = [slice(None)] * a.ndim
        for dc in plan.dead_channels:
            live = [c for c in dc.channels if c < wav]
            if live:
                idx[channel_axis] = live
                a[tuple(idx)] = 0.0
    for i, f in enumerate(plan.adc_spikes):
        e = _EPOCH if f.transient else 0
        mask = _rng(plan, 2, i, e).random(a.shape) < f.rate
        if mask.any():
            a = a + mask * (f.magnitude * float(full_scale))
    return a.astype(np.float32)


def corrupt_shard_values(plan: FaultPlan, vp, array_axis: int = 0):
    """Mesh per-shard faults on the stacked nonzero values.

    Dead arrays (``ArrayLoss``) zero their whole shard — the array is gone,
    its partial output never reaches the sum. Transient ``AdcSpike``
    faults land on a seeded fraction of the surviving shards' stored
    nonzeros (value-domain spikes scaled to the stack's dynamic range), the
    per-shard corruption the ABFT row checksums catch. Returns a new stack;
    the cached mesh layouts are never written through.
    """
    v = np.array(_host(vp), dtype=np.float32)  # copy: cached layouts stay pristine
    n_arrays = v.shape[array_axis]
    idx = [slice(None)] * v.ndim
    scale = float(np.max(np.abs(v))) or 1.0
    for i, f in enumerate(plan.adc_spikes):
        e = _EPOCH if f.transient else 0
        mask = _rng(plan, 3, i, e).random(v.shape) < f.rate
        v = v + mask * (f.magnitude * scale)
    for a in sorted(plan.dead_arrays):
        if a < n_arrays:
            idx[array_axis] = a
            v[tuple(idx)] = 0.0
    return v
