"""Roofline arithmetic on the H100, and the counted FLOPs of a traced step.

The reference derives its roofline from compiled HLO text (``analyze_hlo``:
dot FLOPs, bytes and collective bytes, with ``while`` trip counts
propagated). Nothing in the port produces HLO, so that parser has no
counterpart. In its place :func:`count_flops` runs a step once under
``torch.utils.flop_counter.FlopCounterMode`` — on ``meta`` tensors (shapes
only: no memory, no arithmetic) or on the card — and counts the matrix
products' FLOPs (``mm``, ``bmm``, ``addmm``, attention, convolutions: what
the reference counts as ``dot`` and ``convolution``); :func:`analyze_step`
divides that count per chip.
The bytes term is the caller's: per-device argument and output bytes from
the ``dist.sharding`` spec trees, less the donated ones — a lower bound on
HBM traffic.

The collective term: :func:`fake_world` stands up torch's ``fake`` process
group at the production mesh's size (this process is rank 0; no device,
no traffic) and a ``DeviceMesh`` over it; the caller traces the cell's step
on ``meta`` DTensors placed by their specs, and :func:`count_collectives`
records each c10d collective the trace issues — its op, this rank's
operand bytes and its group's size. :func:`wire_bytes` is the reference's
ring model; the wire bytes over :data:`LINK_BW` are ``collective_s``.

Terms (per chip):
    compute_s    = dot_flops / PEAK_FLOPS
    memory_s     = bytes / HBM_BW
    collective_s = wire bytes / LINK_BW

:func:`model_flops`, :func:`kv_cache_bytes`, :func:`ideal_seconds` and
:func:`_num_attn_layers` are the reference's arithmetic, on the H100's
constants.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.perf_model import H100_BF16_FLOPS_PER_S, H100_HBM_BYTES_PER_S

# hardware constants: an H100 SXM5 80GB (HBM3), its dense bf16 tensor-core
# peak and memory bandwidth (the data sheet's; the kernels' bounds use them)
PEAK_FLOPS = H100_BF16_FLOPS_PER_S      # 989e12 bf16 FLOP/s per card
HBM_BW = H100_HBM_BYTES_PER_S           # 3.35e12 B/s per card
#: NVLink 4 on an H100 SXM5: 900 GB/s a card, 450e9 B/s each way (the data
#: sheet's figure, not a measurement); the ring model's wire bytes a device
#: over it are the collective term
LINK_BW = 450e9


@dataclasses.dataclass
class RooflineResult:
    dot_flops: float = 0.0          # per chip, counted over the traced step
    bytes_essential: float = 0.0    # per chip: arguments + outputs - aliases
    by_op: dict = dataclasses.field(default_factory=dict)   # global FLOPs by aten op
    collective_bytes: float = 0.0       # per chip: the collectives' operand bytes
    collective_wire_bytes: float = 0.0  # per chip: the ring model's wire bytes
    by_collective: dict = dataclasses.field(default_factory=dict)  # op -> count, bytes

    @property
    def compute_s(self) -> float:
        return self.dot_flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_essential / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_wire_bytes / LINK_BW

    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def summary(self) -> dict:
        return {
            "dot_flops": self.dot_flops,
            "bytes_essential": self.bytes_essential,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "collective_bytes": self.collective_bytes,
            "collective_wire_bytes": self.collective_wire_bytes,
            "by_collective": self.by_collective,
            "link_bw": LINK_BW,
            "dominant": self.dominant(),
            "by_op": self.by_op,
        }


def wire_bytes(op: str, operand_bytes: float, out_bytes: float, group: int) -> float:
    """Ring-model wire bytes per device for one collective (the
    reference's model)."""
    g = max(group, 1)
    if op == "all-gather":
        return (g - 1) * operand_bytes
    if op == "all-reduce":
        return 2.0 * (g - 1) / g * operand_bytes
    if op == "reduce-scatter":
        return (g - 1) / g * operand_bytes
    if op == "all-to-all":
        return (g - 1) / g * operand_bytes
    if op == "collective-permute":
        return operand_bytes
    return operand_bytes


def _group_size(group) -> int:
    """The size of a functional collective's group (by name) or of a c10d
    op's process group."""
    from torch.distributed.distributed_c10d import ProcessGroup, _resolve_process_group
    if isinstance(group, str):
        group = _resolve_process_group(group)
    elif isinstance(group, torch.ScriptObject):
        group = ProcessGroup.unbox(group)
    return int(group.size())


def _nbytes(t) -> int:
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


# c10d op name -> (the reference's op name, index of the operand, index of the group)
_COLLECTIVES = {
    "_c10d_functional.all_reduce": ("all-reduce", 0, 2),
    "_c10d_functional.all_reduce_": ("all-reduce", 0, 2),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0, 2),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0, 3),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0, 3),
    "_c10d_functional.broadcast": ("collective-permute", 0, 2),
    "c10d.allreduce_": ("all-reduce", 0, 1),
    "c10d.allgather_": ("all-gather", 1, 2),
    "c10d._allgather_base_": ("all-gather", 1, 2),
    "c10d.reduce_scatter_": ("reduce-scatter", 1, 2),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1, 2),
    "c10d.alltoall_base_": ("all-to-all", 1, 2),
}


class CollectiveCounter(TorchDispatchMode):
    """Records each c10d collective dispatched under it: ``(op, operand
    bytes on this rank, group size)``, the op named as the reference's HLO
    names it."""

    def __init__(self):
        super().__init__()
        self.records: list[tuple[str, int, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(getattr(func, "overloadpacket", func)).removeprefix("torch.ops.")
        if name in _COLLECTIVES:
            op, oi, gi = _COLLECTIVES[name]
            self.records.append((op, _nbytes(args[oi]), _group_size(args[gi])))
        return func(*args, **(kwargs or {}))


def count_collectives(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), records)``: the call's result and the
    collectives :class:`CollectiveCounter` saw it issue."""
    with CollectiveCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.records


def price_collectives(records, repeat: int = 1) -> tuple[float, float, dict]:
    """``(operand bytes, wire bytes, by op)`` a chip of ``records`` issued
    ``repeat`` times; ``by op``: ``{op: {"count", "bytes", "wire_bytes"}}``."""
    by = {}
    for op, nbytes, group in records:
        row = by.setdefault(op, {"count": 0, "bytes": 0.0, "wire_bytes": 0.0})
        row["count"] += repeat
        row["bytes"] += repeat * nbytes
        row["wire_bytes"] += repeat * wire_bytes(op, nbytes, nbytes, group)
    return (sum(r["bytes"] for r in by.values()), sum(r["wire_bytes"] for r in by.values()), by)


@contextlib.contextmanager
def fake_world(mesh):
    """A stand-in for ``mesh`` (a logical production mesh) under torch's
    ``fake`` process group of its size, this process rank 0: a
    :class:`~repro_torch.launch.mesh.ModelMesh` whose tensors are DTensors on
    ``meta``. Raises where the fake group cannot be imported (the
    collective term is never left empty) or a group is already up."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("the dry run's collective term needs torch's fake process group "
                           "(torch.testing._internal.distributed.fake_pg)") from e
    if dist.is_initialized():
        raise RuntimeError("fake_world needs a process with no process group up")
    from repro_torch.launch.mesh import FakeMesh, forget_meshes
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=mesh.size)
    forget_meshes()
    try:
        dm = DeviceMesh("cpu", torch.arange(mesh.size).reshape(mesh.shape),
                        mesh_dim_names=mesh.axis_names)
        yield FakeMesh(mesh.axis_names, mesh.shape, mesh.devices, fake=dm)
    finally:
        dist.destroy_process_group()
        forget_meshes()


def count_flops(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), flops, by_op)``: the call's result and the
    FLOPs ``FlopCounterMode`` counts in it (globally), with their split by
    aten op."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    by_op = {str(op).removeprefix("aten."): int(n)
             for op, n in counter.get_flop_counts().get("Global", {}).items()}
    return out, int(counter.get_total_flops()), by_op


def analyze_step(flops: float, by_op: dict, *, chips: int, repeat: int = 1,
                 bytes_per_chip: float = 0.0, collectives=()) -> RooflineResult:
    """The roofline of a step whose one traced pass :func:`count_flops`
    counted (``flops`` globally, split ``by_op``): the count times
    ``repeat`` (a microbatch loop's trip count) divided over ``chips``;
    ``bytes_per_chip`` is the memory term's bytes; ``collectives`` the
    records :func:`count_collectives` took of one pass on rank 0."""
    cb, wb, by = price_collectives(collectives, repeat)
    return RooflineResult(dot_flops=flops * repeat / chips, bytes_essential=bytes_per_chip,
                          by_op={k: v * repeat for k, v in by_op.items()},
                          collective_bytes=cb, collective_wire_bytes=wb, by_collective=by)


def model_flops(cfg, shape_kind: str, seq: int, global_batch: int,
                dec_frac: float = 0.25) -> float:
    """Analytic useful FLOPs (global, whole step) — the 6ND / 2ND yardstick.

    train: 6*N_active*tokens;  prefill: 2*N_active*tokens;
    decode: 2*N_active*batch (one token each) + attention cache-read flops.
    """
    n = cfg.active_param_count()
    if shape_kind == "train":
        tokens = seq * global_batch
        if cfg.family == "encdec":
            tokens = seq * global_batch * (1 + dec_frac) / 2  # enc fwd-only share
        return 6.0 * n * tokens
    if shape_kind == "prefill":
        return 2.0 * n * seq * global_batch
    # decode: matmul flops + attention KV dot flops
    flops = 2.0 * n * global_batch
    if cfg.family != "ssm":
        n_attn = _num_attn_layers(cfg)
        flops += 4.0 * global_batch * seq * n_attn * cfg.n_heads * cfg.head_dim
    return flops


def kv_cache_bytes(cfg, seq: int, global_batch: int) -> float:
    """Global KV-cache (or SSM state) bytes at bf16."""
    if cfg.family == "ssm":
        per = cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4  # f32 state
        return cfg.num_layers * global_batch * per
    n_attn = _num_attn_layers(cfg)
    kv = n_attn * global_batch * seq * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    if cfg.family == "hybrid":
        per = cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4
        n_ssm = cfg.num_layers - cfg.num_layers // max(cfg.hybrid_attn_period, 1)
        kv += n_ssm * global_batch * per
    return kv


def ideal_seconds(cfg, shape_kind: str, seq: int, global_batch: int,
                  chips: int, model_shards: int = 16) -> float:
    """Roofline target time for one step of this cell.

    train/prefill: compute-bound ideal (MODEL_FLOPS at peak).
    decode: bytes-bound ideal — every device must stream its weight shard
    (TP: 2N/model_shards bytes) plus its share of the KV cache once.
    """
    mf = model_flops(cfg, shape_kind, seq, global_batch)
    ideal_c = mf / chips / PEAK_FLOPS
    if shape_kind != "decode":
        return ideal_c
    w_read = 2.0 * cfg.active_param_count() / model_shards
    kv_read = kv_cache_bytes(cfg, seq, global_batch) / chips
    return max(ideal_c, (w_read + kv_read) / HBM_BW)


def _num_attn_layers(cfg) -> int:
    if cfg.family == "encdec":
        return 2 * cfg.dec_layers  # self + cross per decoder layer at decode
    if cfg.family == "hybrid" and cfg.hybrid_attn_period:
        return cfg.num_layers // cfg.hybrid_attn_period
    if cfg.family == "ssm":
        return 0
    return cfg.num_layers
