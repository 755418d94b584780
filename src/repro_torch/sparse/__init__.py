"""repro_torch.sparse — the sparse-tensor subsystem of the port.

* ``formats`` — COO / SortedCOO / BlockedCOO / CSF containers with
  conversions, validation, and root-fiber slicing.
* ``synth``   — FROSTT-style synthetic tensors with power-law fiber lengths.
* ``stream``  — the block layout of the nonzero-streaming MTTKRP schedule
  and its executors (eager and compiled, exact or quantized chain), the
  flat blocked-fold oracle and the COO front doors.

Still to come from the reference package: ``partition``, ``mesh``, and the
rest of ``stream`` (the schedule IR and pricing, ROADMAP Queue A item 3).
"""
from .formats import COO, CSF, BlockedCOO, SortedCOO, csf_for_mode
from .stream import (blocked_fold_reference, stream_layout, stream_mttkrp, stream_mttkrp_blocked,
                     stream_mttkrp_coo)
from .synth import FiberStats, powerlaw_coo, powerlaw_fiber_lengths

__all__ = [
    "COO",
    "CSF",
    "BlockedCOO",
    "SortedCOO",
    "FiberStats",
    "blocked_fold_reference",
    "csf_for_mode",
    "powerlaw_coo",
    "powerlaw_fiber_lengths",
    "stream_layout",
    "stream_mttkrp",
    "stream_mttkrp_blocked",
    "stream_mttkrp_coo",
]
