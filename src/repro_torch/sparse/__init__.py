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
  that the mesh executor and the analytical mesh price plan on, the planned
  split with its per-array stream programs (``partition_fiber_lengths``),
  a CSF's split into shards (``partition_csf``, with ``n_arrays`` or a
  ``mesh``) and the array count a mesh gives (``arrays_for_mesh``).
* ``mesh``      — the stream across many arrays: a launch per planned shard,
  the partials added by the reduction fabric (``mesh_stream_mttkrp``), the
  split Grams for CP-ALS (``mesh_gram``), and the counted mesh price
  (``mesh_counted_price``) the ``"psram-mesh"`` backend bills against.
"""
from .formats import COO, CSF, BlockedCOO, SortedCOO, csf_for_mode
from .mesh import (MESH_LOWERINGS, mesh_counted_price, mesh_gram, mesh_stream_mttkrp,
                   resolve_array_mesh)
from .partition import (PLANNERS, MeshedSparseTensor, Partition, PartitionedSchedule,
                        arrays_for_mesh, imbalance, makespan_partitions, nnz_balanced_partitions,
                        partition_csf, partition_fiber_lengths, plan_partitions)
from .stream import (StreamedMTTKRP, blocked_fold_reference, build_stream_program,
                     rank_tile_widths, stream_layout, stream_mttkrp, stream_mttkrp_blocked,
                     stream_mttkrp_coo, stream_mttkrp_priced)
from .synth import FiberStats, powerlaw_coo, powerlaw_fiber_lengths

__all__ = [
    "COO",
    "CSF",
    "BlockedCOO",
    "MESH_LOWERINGS",
    "MeshedSparseTensor",
    "PLANNERS",
    "SortedCOO",
    "FiberStats",
    "Partition",
    "PartitionedSchedule",
    "arrays_for_mesh",
    "StreamedMTTKRP",
    "blocked_fold_reference",
    "build_stream_program",
    "csf_for_mode",
    "imbalance",
    "makespan_partitions",
    "mesh_counted_price",
    "mesh_gram",
    "mesh_stream_mttkrp",
    "nnz_balanced_partitions",
    "partition_csf",
    "partition_fiber_lengths",
    "plan_partitions",
    "powerlaw_coo",
    "powerlaw_fiber_lengths",
    "rank_tile_widths",
    "resolve_array_mesh",
    "stream_layout",
    "stream_mttkrp",
    "stream_mttkrp_blocked",
    "stream_mttkrp_coo",
    "stream_mttkrp_priced",
]
