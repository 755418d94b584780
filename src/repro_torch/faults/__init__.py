"""repro_torch.faults — device-fault injection, ABFT, and degraded-mode control.

Three layers, front to back:

* :mod:`~repro_torch.faults.plan` — seeded, wall-clock-free fault models
  (:class:`FaultPlan`: stuck bits, ADC spikes, dead WDM channels, laser
  drift, array loss) and the :func:`inject` runtime the executors hook
  (``core.schedule``'s vectorized executor and ``sparse.mesh``'s shards);
  the corruption transforms draw the reference's sites for the same seed.
* :mod:`~repro_torch.faults.abft` — checksum detect → locate → re-drive for
  matmul and MTTKRP, thresholds calibrated to each backend's documented
  ``Capabilities.rel_tol``, recovery priced by the cycle accountant.
* :mod:`~repro_torch.faults.degraded` — whole-array loss: recover the lost
  fiber ranges bit-identically and re-plan the survivors.

Only :mod:`.plan` imports eagerly: ``core.schedule`` and ``sparse.mesh``
import it for their zero-cost hooks, and the ABFT/degraded modules import
those right back — the lazy ``__getattr__`` below is what keeps that cycle
open-circuited.
"""
from .plan import (
    AdcSpike,
    ArrayLoss,
    DeadChannel,
    FaultPlan,
    LaserDrift,
    StuckBit,
    active,
    bump_epoch,
    corrupt_analog,
    corrupt_shard_values,
    corrupt_stored,
    epoch,
    inject,
    suspended,
)

__all__ = [
    "AbftConfig",
    "AbftReport",
    "AdcSpike",
    "ArrayLoss",
    "DeadChannel",
    "DegradedReport",
    "FaultPlan",
    "LaserDrift",
    "StuckBit",
    "abft_matmul",
    "abft_mttkrp",
    "active",
    "bump_epoch",
    "corrupt_analog",
    "corrupt_shard_values",
    "corrupt_stored",
    "degraded_mesh_mttkrp",
    "epoch",
    "inject",
    "recover_dead_rows",
    "suspended",
]

_LAZY = {
    "AbftConfig": ".abft",
    "AbftReport": ".abft",
    "abft_matmul": ".abft",
    "abft_mttkrp": ".abft",
    "DegradedReport": ".degraded",
    "degraded_mesh_mttkrp": ".degraded",
    "recover_dead_rows": ".degraded",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from importlib import import_module

    return getattr(import_module(mod, __name__), name)
