"""repro_torch.sparse — the sparse-tensor subsystem of the port.

* ``formats``   — COO / SortedCOO / BlockedCOO / CSF containers with
  conversions, validation, and root-fiber slicing.
* ``synth``     — FROSTT-style synthetic tensors with power-law fiber lengths.
* ``stream``    — the nonzero-streaming MTTKRP schedule: its block layout,
  its executors (eager and compiled, exact or quantized chain), the flat
  blocked-fold oracle, the COO front doors, and the schedule as
  ``core.schedule`` IR (``build_stream_program``) with its price
  (``stream_mttkrp_priced``).
* ``partition`` — the multi-array planners (nnz-balanced, makespan-refined)
  the analytical mesh price plans on, and the planned split with its
  per-array stream programs (``partition_fiber_lengths``).

Still to come from the reference package: ``mesh`` and the rest of
``partition`` (ROADMAP Queue A item 4).
"""
from .formats import COO, CSF, BlockedCOO, SortedCOO, csf_for_mode
from .partition import (PLANNERS, Partition, PartitionedSchedule, imbalance,
                        makespan_partitions, nnz_balanced_partitions, partition_fiber_lengths,
                        plan_partitions)
from .stream import (StreamedMTTKRP, blocked_fold_reference, build_stream_program,
                     rank_tile_widths, stream_layout, stream_mttkrp, stream_mttkrp_blocked,
                     stream_mttkrp_coo, stream_mttkrp_priced)
from .synth import FiberStats, powerlaw_coo, powerlaw_fiber_lengths

__all__ = [
    "COO",
    "CSF",
    "BlockedCOO",
    "PLANNERS",
    "SortedCOO",
    "FiberStats",
    "Partition",
    "PartitionedSchedule",
    "StreamedMTTKRP",
    "blocked_fold_reference",
    "build_stream_program",
    "csf_for_mode",
    "imbalance",
    "makespan_partitions",
    "nnz_balanced_partitions",
    "partition_fiber_lengths",
    "plan_partitions",
    "powerlaw_coo",
    "powerlaw_fiber_lengths",
    "rank_tile_widths",
    "stream_layout",
    "stream_mttkrp",
    "stream_mttkrp_blocked",
    "stream_mttkrp_coo",
    "stream_mttkrp_priced",
]
