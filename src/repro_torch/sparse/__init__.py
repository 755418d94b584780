"""repro_torch.sparse — the sparse-tensor subsystem of the port.

* ``formats`` — COO / SortedCOO / BlockedCOO / CSF containers with
  conversions, validation, and root-fiber slicing.
* ``synth``   — FROSTT-style synthetic tensors with power-law fiber lengths.
* ``stream``  — the block layout of the nonzero-streaming MTTKRP schedule,
  its exact eager executor and the blocked segment-sum executor.

Still to come from the reference package: ``partition``, ``mesh``, and the
rest of ``stream`` (schedule IR, quantized and compiled executors, pricing).
"""
from .formats import COO, CSF, BlockedCOO, SortedCOO, csf_for_mode
from .stream import stream_layout, stream_mttkrp, stream_mttkrp_blocked
from .synth import FiberStats, powerlaw_coo, powerlaw_fiber_lengths

__all__ = [
    "COO",
    "CSF",
    "BlockedCOO",
    "SortedCOO",
    "FiberStats",
    "csf_for_mode",
    "powerlaw_coo",
    "powerlaw_fiber_lengths",
    "stream_layout",
    "stream_mttkrp",
    "stream_mttkrp_blocked",
]
