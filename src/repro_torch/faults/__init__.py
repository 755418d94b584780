"""repro_torch.faults — device-fault injection for the port.

Ported: :mod:`~repro_torch.faults.plan` — seeded, wall-clock-free fault
models (:class:`FaultPlan`: stuck bits, ADC spikes, dead WDM channels, laser
drift, array loss), the :func:`inject` runtime the executors hook, and the
corruption transforms, which draw the reference's sites for the same seed.
``sparse.mesh`` imports it for its zero-cost shard-fault hook.

Still to come from the reference package (ROADMAP Queue A item 6):
``abft`` (checksum detect → locate → re-drive for matmul and MTTKRP),
``degraded`` (whole-array loss recovered on the survivors) and the
schedule executor's fault hooks.
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
    "AdcSpike",
    "ArrayLoss",
    "DeadChannel",
    "FaultPlan",
    "LaserDrift",
    "StuckBit",
    "active",
    "bump_epoch",
    "corrupt_analog",
    "corrupt_shard_values",
    "corrupt_stored",
    "epoch",
    "inject",
    "suspended",
]
