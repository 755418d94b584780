"""Placement across several ranks: DTensors over a ``DeviceMesh``.

A :class:`~repro_torch.launch.mesh.ModelMesh` under a process group (one
process a card, ``launch.mesh.init_distributed``) is a ``DeviceMesh`` with
the mesh's axis names. A tensor with a :class:`~repro_torch.dist.sharding.
PartitionSpec` on it is a ``DTensor`` whose placement on mesh axis ``a`` is
``Shard(d)`` where the spec names ``a`` at dimension ``d``, else
``Replicate()`` (:func:`placements`). A dimension claimed by a tuple of axes
(``("pod", "data")``) shards over their product, the first axis major: the
block of mesh coordinates ``(i, j)`` is ``i * size(data) + j``, the block
``jax.sharding.NamedSharding`` gives the same spec. DTensor splits a
dimension over several mesh dims in mesh order, so a tuple's axes must come
in the mesh's order; every claim of ``dist.sharding`` does, and another
order raises.

Every rank draws each full leaf from the same seed and keeps its own block
(:func:`distribute`, no communication): weights equal the one-card draw, and
the peak is the largest leaf. Model code reaches the local blocks only
where DTensor has no rule for an op (kernel 2, the MoE dispatch, the
vocab-parallel cross entropy); it never lets DTensor replicate a sharded
weight to make an op fit: :func:`gathered` is the one place a weight is
gathered, over the data axes under FSDP.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch._tree import tree_map

__all__ = ["DTensor", "Partial", "Replicate", "Shard", "distribute", "distribute_as",
           "distribute_tree", "full", "gathered", "init_placed", "is_dtensor", "placements",
           "redistribute", "reshape"]


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec, axis_names) -> tuple:
    """The DTensor placements of ``spec`` on a mesh with ``axis_names``: one a
    mesh axis, ``Shard(d)`` where the spec names the axis at ``d``. A tuple
    claim must list its axes in the mesh's order (major first)."""
    axis_names = tuple(axis_names)
    out = [Replicate()] * len(axis_names)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [axis_names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} lists mesh axes out of the mesh's order "
                             f"{axis_names}: DTensor shards a dimension major axis first")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def distribute(t: torch.Tensor, mesh, spec) -> DTensor:
    """``t`` (the same full tensor on every rank) as a DTensor with ``spec``
    on ``mesh``: each rank keeps its own block, nothing is sent."""
    if is_dtensor(t):
        return redistribute(t, mesh, spec)
    dm = mesh.device_mesh()
    pls = placements(spec, mesh.axis_names)
    return DTensor.from_local(_block(t, dm, pls), dm, pls, shape=t.shape,
                              stride=_contiguous_stride(t.shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _block(t, dm, pls):
    """This rank's block of ``t`` under ``pls`` (torch.chunk's split, as
    DTensor's own ``Shard``): a copy where a dimension is split, so the full
    tensor can be freed; ``t`` itself where it is replicated."""
    if not any(isinstance(p, Shard) for p in pls):
        return t.contiguous()
    coord = dm.get_coordinate()
    local = t
    for i, p in enumerate(pls):
        if isinstance(p, Shard):
            n = dm.size(i)
            if local.shape[p.dim] % n:
                raise ValueError(f"dimension {p.dim} of {tuple(t.shape)} does not divide over "
                                 f"mesh axis {dm.mesh_dim_names[i]} ({n})")
            local = local.chunk(n, dim=p.dim)[coord[i]]
    return local.clone(memory_format=torch.contiguous_format)


def redistribute(x: DTensor, mesh, spec) -> DTensor:
    """``x`` moved to ``spec`` on ``mesh`` (a no-op where it is there)."""
    pls = placements(spec, mesh.axis_names)
    if tuple(x.placements) == pls:
        return x
    return x.redistribute(mesh.device_mesh(), pls)


def distribute_tree(tree, specs, mesh, fsdp: bool = False, rules=None):
    """A tree of full tensors placed by its logical-spec tree (``param_specs``,
    ``cache_specs``, ``state_spec_tree``), leaf by leaf."""
    from .sharding import logical_to_spec

    def one(t, axes):
        return distribute(t, mesh, logical_to_spec(tuple(axes), t.shape, mesh, fsdp, rules))

    return tree_map(one, tree, specs)


def full(x):
    """The whole tensor on every rank (a gather), or ``x`` itself."""
    return x.full_tensor() if is_dtensor(x) else x


def gathered(w, keep=("model",)):
    """``w`` with every mesh axis but ``keep`` replicated: a weight sharded
    over the data axes (FSDP) gathered for its use, its gradient
    reduce-scattered back by autograd. The tensor-parallel blocks stay."""
    if not is_dtensor(w):
        return w
    names = w.device_mesh.mesh_dim_names
    pls = tuple(p if n in keep else Replicate() for n, p in zip(names, w.placements))
    return w if pls == tuple(w.placements) else w.redistribute(w.device_mesh, pls)


def reshape(x, *shape):
    """``x.reshape(shape)``. A DTensor whose sharded dimension the view cannot
    keep sharded (2 kv heads split out of a dimension sharded 4 ways) is
    first replicated on those mesh axes; an activation moves, never a
    weight. Decided from the shapes alone (no failed dispatch: a
    checkpointed region replays its ops)."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    old, new = tuple(x.shape), tuple(shape)
    pre = 0
    while pre < min(len(old), len(new)) and old[pre] == new[pre]:
        pre += 1
    suf = 0
    while (suf < min(len(old), len(new)) - pre
           and old[len(old) - 1 - suf] == new[len(new) - 1 - suf]):
        suf += 1
    lo, hi_old, hi_new = pre, len(old) - suf, len(new) - suf
    mesh = x.device_mesh
    by_dim = {}
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            by_dim.setdefault(p.dim % x.ndim, []).append(i)

    def keeps(d, n):
        if d < lo or d >= hi_old:
            return True
        if hi_old - lo == 1:                       # one dim split into several
            return new[lo] % n == 0
        return hi_new - lo == 1 and d == lo        # several merged into one
    pls = list(x.placements)
    for d, idx in by_dim.items():
        n = 1
        for i in idx:
            n *= mesh.size(i)
        if not keeps(d, n):
            for i in idx:
                pls[i] = Replicate()
    if tuple(pls) != tuple(x.placements):
        x = x.redistribute(mesh, pls)
    return x.reshape(*shape)


def axis_group(x, name: str):
    """The process group of mesh axis ``name`` of ``x``'s mesh."""
    return x.device_mesh.get_group(name)


def axis_placement(x, name: str):
    """``x``'s placement on mesh axis ``name`` (``Replicate`` where the mesh
    has no such axis)."""
    names = x.device_mesh.mesh_dim_names
    return x.placements[names.index(name)] if name in names else Replicate()


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of a local tensor over ``group`` (no autograd)."""
    if dist.get_world_size(group) > 1:
        dist.all_reduce(t, op=op, group=group)
    return t


def settled(x):
    """``x`` with every ``Partial`` placement reduced to ``Replicate`` (the
    pending all-reduce done), or ``x`` itself."""
    if not is_dtensor(x) or not any(isinstance(p, Partial) for p in x.placements):
        return x
    pls = tuple(Replicate() if isinstance(p, Partial) else p for p in x.placements)
    return x.redistribute(x.device_mesh, pls)


def init_placed(cfg, seed, mesh, fsdp: bool = False, rules=None, device=None):
    """``cfg``'s random parameters on ``mesh``, placed by its
    ``param_specs``: every rank draws each full leaf on its own device from
    ``seed`` (the one-card draw's stream) and keeps its block, so the
    weights equal ``init(seed, cfg)`` on one card."""
    from repro_torch.models.layers import as_dtype, init_params
    from repro_torch.models.registry import get_module

    from .sharding import logical_to_spec

    def place(leaf, axes):
        return distribute(leaf, mesh, logical_to_spec(tuple(axes), leaf.shape, mesh, fsdp, rules))

    defs = get_module(cfg).param_defs(cfg)
    return init_params(seed, defs, dtype=as_dtype(cfg.dtype),
                       device=device or mesh.local_device(), place=place)


def to_local_partial(x):
    """``x``'s local block inside a region of local code, its gradient
    declared ``Partial`` on every axis where ``x`` is replicated: each rank
    uses the whole of it for its own share of the work (its experts, its
    columns, its batch), so the ranks' gradients add."""
    if not is_dtensor(x):
        return x
    return x.to_local(grad_placements=[Partial() if isinstance(p, Replicate) else p
                                       for p in x.placements])


def placed_like(x, *, model=None):
    """``x``'s placements with the ``"model"`` axis set to ``model`` (kept
    where None)."""
    names = x.device_mesh.mesh_dim_names
    return tuple(model if (n == "model" and model is not None) else p
                 for n, p in zip(names, x.placements))


def write_position(leaf: DTensor, delta, p0: int) -> None:
    """``leaf[:, p0:p0 + 1] = delta`` on a placed cache ``(B, S, ...)``: the
    rank whose block of the sequence holds ``p0`` writes it (a cache
    sharded over its sequence, ``seq_kv``), every other dimension as the
    leaf lies."""
    mesh = leaf.device_mesh
    pls = leaf.placements
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in pls)
    if is_dtensor(delta):
        delta = delta.redistribute(mesh, want) if tuple(delta.placements) != want else delta
        d_l = delta.to_local()
    else:
        d_l = delta
    lo, size = 0, leaf.shape[1]
    coord = mesh.get_coordinate()
    for i, p in enumerate(pls):
        if isinstance(p, Shard) and p.dim == 1:
            size //= mesh.size(i)
            lo += coord[i] * size
    if lo <= p0 < lo + size:
        blk = leaf.to_local()
        blk[:, p0 - lo:p0 - lo + 1] = d_l.to(blk.dtype)


def distribute_as(t: torch.Tensor, like: DTensor) -> DTensor:
    """``t`` (the whole tensor, the same on every rank) placed as ``like``."""
    dm = like.device_mesh
    pls = tuple(like.placements)
    return DTensor.from_local(_block(t.to(like.device), dm, pls), dm, pls, shape=t.shape,
                              stride=_contiguous_stride(t.shape))
