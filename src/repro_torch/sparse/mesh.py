"""Mesh-sharded execution of the streaming MTTKRP — many pSRAM arrays.

The scale-out step past one array (the paper's §V single-array headline →
the system-level many-array regime): the planned partitions of
:mod:`repro_torch.sparse.partition` land on the arrays of an
:class:`~repro_torch.launch.mesh.ArrayMesh`, every array streams its own
shard of the sorted nonzero stream, and one reduction — the electrical
fabric — adds the per-array partial outputs.

Where the reference runs one SPMD program under ``shard_map`` with a
``psum``, the port runs **one loop over the arrays**: each shard launches
one of the port's existing routes on the device that hosts its array
(round-robin; on one card the shards run in turn), and :func:`reduce_partials`
— the one seam where a ``torch.distributed`` all-reduce would go — adds the
partials in the mesh's array order on its first device.

Numeric contracts (tests/test_torch_mesh.py):

* The planner never splits a root fiber across arrays, so every output row
  is computed *entirely* on one shard — the other shards contribute exact
  zeros to its sum. The **eager** lowering (per shard the eager
  ``stream_mttkrp`` executor: on the card one launch of the ordered fold's
  chain route, quantized with ``psram=True``) is therefore *bit-identical*
  to the single-device stream and independent of the array count and order.
* The **compiled** lowering runs the blocked-segment fold per shard (kernel
  5's chain route + the ordered fold's fold route on the card; reassociated
  adds); the **fused** lowering runs the int8 fused chunk kernel per shard
  (kernel 1) at one ``exec_blocks`` for every shard, derived from the
  largest as in the reference — both within the documented ADC envelope
  (rel 0.05) of ``"exact"``.
* Empty shards (fibers < arrays) contribute zeros and price zero cycles;
  they launch nothing.

Faults: with a :class:`~repro_torch.faults.plan.FaultPlan` armed, the
shards' values are stacked in the reference's shapes (an array axis, padded
to the global chunk count), corrupted by ``corrupt_shard_values`` there —
so a seeded plan lands on the same slots — and each shard is handed its
slice.

Pricing: :func:`mesh_counted_price` walks the per-array op lists
(``count_cycles``) and adds the fabric's all-reduce through the SAME
closed form (``perf_model.allreduce_cycles``) the analytical mesh price
uses — analytical == counted stays exact at mesh scale.

Spans and counters, the reference's: ``mesh/shard{i}/plan`` (nnz) and
``mesh/shard{i}/nnz`` per planned shard, ``mesh/stream/execute`` (nnz,
n_arrays, lowering, planner, mode) around the run, and
``fault/mesh/shard_values`` (arrays, dead) with ``fault/arrays_lost`` while
a plan is armed. :func:`mesh_plan_timeline` renders the per-array tracks of
the plan a run executed (``obs.mesh_timeline``). The whole reference module
is ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import ieee_f32
from repro_torch.backends.base import resolve_config
from repro_torch.core.psram import PsramConfig
from repro_torch.faults import plan as _faults
from repro_torch.launch.mesh import ArrayMesh, make_array_mesh

from .formats import CSF
from .partition import MeshedSparseTensor, partition_csf
from .stream import _exec_blocks, _stream_eager, stream_layout, stream_mttkrp_blocked

MESH_LOWERINGS = ("eager", "compiled", "fused")


def resolve_array_mesh(mesh: ArrayMesh | None = None, n_arrays: int | None = None,
                       device: str | torch.device = "cuda") -> ArrayMesh:
    """The array mesh a run executes on: pass an existing mesh or an array
    count (``None`` = one array per visible device of ``device``'s type)."""
    if mesh is None:
        return make_array_mesh(n_arrays, device=torch.device(device).type)
    if not isinstance(mesh, ArrayMesh):
        raise ValueError(f"mesh sparse execution needs a 1-D ArrayMesh (one axis of "
                         f"arrays); got {type(mesh).__name__}")
    if n_arrays is not None and n_arrays != mesh.n_arrays:
        raise ValueError(f"n_arrays={n_arrays} disagrees with the {mesh.n_arrays}-array "
                         "mesh; pass one or the other")
    return mesh


def _mesh_partition(csf: CSF, n_arrays: int, rank: int, cfg: PsramConfig,
                    planner: str) -> MeshedSparseTensor:
    """The planned split of ``csf`` over ``n_arrays``, cached on the CSF
    (immutable; CP-ALS revisits the same tensor every sweep)."""
    key = ("_mesh_partition", n_arrays, rank, cfg, planner)
    cached = csf.__dict__.get(key)
    if cached is None:
        cached = partition_csf(csf, n_arrays=n_arrays, rank=rank, config=cfg,
                               planner=planner)
        csf.__dict__[key] = cached
    return cached


def _shard_on(shard: CSF, device: torch.device) -> CSF:
    """``shard`` with its values on ``device`` (itself where they are
    already there), cached on the shard: the per-device layouts the routes
    cache stay with it."""
    if shard.values.device == device:
        return shard
    key = ("_mesh_shard_on", str(device))
    moved = shard.__dict__.get(key)
    if moved is None:
        moved = dataclasses.replace(shard, values=shard.values.to(device))
        shard.__dict__[key] = moved
    return moved


# ---------------------------------------------------------------------------
# shard faults — the reference's stacked shapes, so a seeded plan lands on
# the same slots
# ---------------------------------------------------------------------------


def _value_stack(meshed: MeshedSparseTensor, lowering: str, rows: int,
                 exec_blocks: int) -> np.ndarray:
    """The shards' values stacked as the reference stacks them: ``(A, nb,
    rows·exec_blocks)`` for the eager lowering, ``(A, nb, exec_blocks,
    rows)`` for the blocked ones (every shard's own ``stream_layout``
    padded to the largest chunk count), zero-padded."""
    shards = meshed.shards
    if lowering == "eager":
        chunk = rows * exec_blocks
        nb = max(1, max(-(-s.nnz // chunk) for s in shards))
        inner = (chunk,)
    else:
        nb = max(-(-max(1, -(-s.nnz // rows)) // exec_blocks) for s in shards)
        inner = (exec_blocks, rows)
    per = nb * int(np.prod(inner))
    stack = np.zeros((len(shards), per), dtype=np.float32)
    for a, s in enumerate(shards):
        stack[a, :s.nnz] = s.values.detach().cpu().numpy()
    return stack.reshape((len(shards), nb) + inner)


def _faulty_values(meshed: MeshedSparseTensor, lowering: str, rows: int,
                   exec_blocks: int):
    """Per-shard fault hook (zero-cost when no plan is armed): ``None``, or
    each shard's corrupted values — its flat slice of the stacked values
    after ``corrupt_shard_values`` (dead arrays zero their slice, transient
    spikes hit the survivors), padding included. The shards themselves are
    never written through, so disarming restores clean runs."""
    plan = _faults._ACTIVE
    if plan is None or not (plan.array_loss or plan.adc_spikes):
        return None
    if obs.enabled() and plan.array_loss:
        obs.counter("fault/arrays_lost", len(plan.dead_arrays))
    stack = _value_stack(meshed, lowering, rows, exec_blocks)
    with obs.span("fault/mesh/shard_values", arrays=int(stack.shape[0]),
                  dead=len(plan.dead_arrays)):
        # f32 as the stream holds it (a spike's sum is float64 on the host)
        out = _faults.corrupt_shard_values(plan, stack).astype(np.float32)
    return [out[a].reshape(-1) for a in range(out.shape[0])]


# ---------------------------------------------------------------------------
# the executor: one loop over the arrays, one reduction
# ---------------------------------------------------------------------------


def reduce_partials(partials: list, mesh: ArrayMesh, shape: tuple) -> torch.Tensor:
    """The reduction fabric: the arrays' partial outputs ``(out_rows, R)``
    added in the mesh's array order on its first device (``None`` is an
    array that contributed nothing). The one seam where a
    ``torch.distributed`` all-reduce goes when the arrays span processes."""
    dev = mesh.devices[0]
    out = None
    for a in mesh.run_order():
        part = partials[a]
        if part is None:
            continue
        part = part.to(dev)
        out = part if out is None else out + part
    if out is None:
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    return out


def _run_shard(shard: CSF, factors: tuple, cfg: PsramConfig, lowering: str, mode: int,
               exec_blocks: int, psram: bool, adc_bits: int,
               values: np.ndarray | None) -> torch.Tensor:
    """One array's partial output ``(out_rows, R)`` on the shard's device.
    ``values`` (the shard's faulted slice, padding included) stands in for
    its own."""
    from repro_torch.kernels.stream_mttkrp import (segment_plan, stream_factor_quants,
                                                   stream_mttkrp_fused)

    rows = cfg.rows
    dev = shard.values.device
    out_rows = shard.shape[mode]
    if lowering != "fused":
        v = None if values is None else torch.as_tensor(values[:shard.nnz], device=dev)
        if lowering == "eager":
            return _stream_eager(shard, factors, mode, rows * exec_blocks, psram, adc_bits,
                                 values=v)
        return stream_mttkrp_blocked(shard, factors, cfg, psram=psram, adc_bits=adc_bits,
                                     values=v)
    ip, vp, lp, sp, n_seg = stream_layout(shard, rows, exec_blocks)
    if values is not None:       # the chunk-wide ADC sees the padding's spikes too
        vp = torch.as_tensor(values[:vp.numel()], device=dev).view(vp.shape)
    qs, ss = stream_factor_quants(factors, mode)
    plan = segment_plan(shard, rows, lp, sp, n_seg) if ip.is_cuda else None
    return stream_mttkrp_fused(ip, vp, lp, sp, qs, ss, mode, n_seg, adc_bits, out_rows,
                               plan=plan)


def mesh_stream_mttkrp(
    csf: CSF,
    factors: tuple,
    config: PsramConfig | None = None,
    mesh: ArrayMesh | None = None,
    n_arrays: int | None = None,
    psram: bool = True,
    adc_bits: int = 16,
    lowering: str = "eager",
    planner: str = "makespan",
    exec_blocks: int | None = None,
) -> torch.Tensor:
    """One sparse MTTKRP across the array mesh: ``(out_rows, R)``.

    ``csf``'s root mode is the target mode; every array streams its planned
    shard against the factors (copied to its device), and the partial
    outputs add into the result on the mesh's first device. ``lowering``
    picks the per-shard fold: ``"eager"`` (bit-identical to the
    single-device stream and to ``mttkrp_sparse_psram``), ``"compiled"``
    (blocked-segment fold), or ``"fused"`` (the int8 fused chunk kernel).
    ``mesh=None`` makes one of ``n_arrays`` arrays over the visible devices
    of the CSF's device type; one array degenerates to exactly the
    single-device schedule.
    """
    if lowering not in MESH_LOWERINGS:
        raise ValueError(
            f"unknown mesh lowering {lowering!r}; pick one of {MESH_LOWERINGS}")
    cfg = resolve_config(config)
    mesh = resolve_array_mesh(mesh, n_arrays, device=csf.device)
    n = mesh.n_arrays
    mode = csf.mode_order[0]
    out_rows = csf.shape[mode]
    rank = int(factors[0].shape[-1])
    meshed = _mesh_partition(csf, n, rank, cfg, planner)
    rows = cfg.rows
    max_nnz = max(1, max(s.nnz for s in meshed.shards))
    eb = _exec_blocks(rows, max(1, -(-max_nnz // rows)), exec_blocks)
    if obs.enabled():
        for i, s in enumerate(meshed.shards):
            with obs.span(f"mesh/shard{i}/plan", nnz=s.nnz):
                pass
            obs.counter(f"mesh/shard{i}/nnz", s.nnz)
    with obs.span("mesh/stream/execute", nnz=csf.nnz, n_arrays=n,
                  lowering=lowering, planner=planner, mode=mode):
        values = _faulty_values(meshed, lowering, rows, eb)
        on_device = {}
        partials = [None] * n
        for a in mesh.run_order():
            shard = meshed.shards[a]
            if shard.nnz == 0:
                continue
            dev = mesh.device_of(a)
            if dev not in on_device:
                on_device[dev] = tuple(f.to(dev) for f in factors)
            partials[a] = _run_shard(_shard_on(shard, dev), on_device[dev], cfg, lowering,
                                     mode, eb, psram, adc_bits,
                                     None if values is None else values[a])
        return reduce_partials(partials, mesh, (out_rows, rank))


def mesh_plan_timeline(csf: CSF, rank: int, config: PsramConfig | None = None,
                       mesh: ArrayMesh | None = None, n_arrays: int | None = None,
                       planner: str = "makespan", fabric=None,
                       max_events: int = 100_000) -> list[dict]:
    """The per-array tracks (``obs.mesh_timeline``) of the plan
    :func:`mesh_stream_mttkrp` runs on ``csf`` with the same arguments — the
    partition cached on the CSF, not a new one — with the fabric's
    all-reduce of the non-empty output rows at the makespan."""
    from repro_torch.obs.timeline import mesh_timeline

    cfg = resolve_config(config)
    mesh = resolve_array_mesh(mesh, n_arrays, device=csf.device)
    meshed = _mesh_partition(csf, mesh.n_arrays, rank, cfg, planner)
    return mesh_timeline(csf.fiber_lengths(), rank, config=cfg, n_arrays=mesh.n_arrays,
                         planner=planner, fabric=fabric, max_events=max_events,
                         schedule=meshed)


# ---------------------------------------------------------------------------
# all-reduced Gram matrices (the CP-ALS normal equations)
# ---------------------------------------------------------------------------


@ieee_f32()
def mesh_gram(f: torch.Tensor, mesh: ArrayMesh | None = None,
              n_arrays: int | None = None) -> torch.Tensor:
    """``f.T @ f`` with the rows of ``f`` split over the arrays and the
    ``(R, R)`` partial Grams added by :func:`reduce_partials` — the sharded
    form of the CP-ALS normal-equation Grams, in IEEE f32. Zero-row padding
    makes any row count divisible; the split reassociates the row
    reduction, so the result is allclose (not bit-equal) to the one-piece
    Gram, which one array computes."""
    mesh = resolve_array_mesh(mesh, n_arrays, device=f.device)
    n = mesh.n_arrays
    if n == 1:
        return f.T @ f
    pad = (-f.shape[0]) % n
    blocks = torch.nn.functional.pad(f, (0, 0, 0, pad)).view(n, -1, f.shape[1])
    partials = []
    for a in range(n):
        b = blocks[a].to(mesh.device_of(a))
        partials.append(b.T @ b)
    return reduce_partials(partials, mesh, (f.shape[1], f.shape[1]))


# ---------------------------------------------------------------------------
# counted mesh pricing (the measured side of estimate == measured)
# ---------------------------------------------------------------------------


def mesh_counted_price(
    fiber_lengths,
    rank: int,
    config: PsramConfig | None = None,
    n_arrays: int = 1,
    fabric=None,
    planner: str = "makespan",
    out_rows: int | None = None,
):
    """:class:`~repro_torch.core.perf_model.MeshPrice` from the counted op
    lists: one stream program per planned partition walked by
    ``count_cycles``, plus the fabric all-reduce — the same closed form the
    analytical price adds, so the two agree exactly."""
    from repro_torch.core.perf_model import MeshPrice, allreduce_cycles
    from repro_torch.core.schedule import count_cycles

    from .partition import partition_fiber_lengths

    cfg = resolve_config(config)
    f = np.asarray(fiber_lengths, dtype=np.int64)
    ps = partition_fiber_lengths(f, n_arrays, rank, cfg, planner=planner)
    reduced = int((f > 0).sum()) if out_rows is None else int(out_rows)
    return MeshPrice(
        per_array=tuple(count_cycles(p) for p in ps.programs),
        reduce_cycles=allreduce_cycles(reduced, rank, n_arrays, fabric),
        n_arrays=n_arrays,
    ), ps
