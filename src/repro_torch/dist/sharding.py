"""Logical-axis sharding: map logical tensor axes onto mesh axes.

Models describe tensors with *logical* axis names (``("embed", "ff")``,
``("batch", "seq_kv", "kv_heads", None)``); this module decides which *mesh*
axes ("pod", "data", "model", or a pSRAM mesh's "array") each one occupies.
One rule set serves every consumer — the models' activation hints, the
dry run's parameter / optimizer-state / cache shardings and the data batch —
so tensor parallelism, (pod-)data parallelism, FSDP and sequence parallelism
all fall out of the same function.

Assignment is priority-ordered with divisibility fallback:

1. *Primary* claims first, in position order: tensor-parallel names
   ("ff", "qdim", "kvdim", "heads", "kv_heads", "experts", "vocab") claim the
   "model" axis; "batch" claims the data axes — ``("pod", "data")`` together
   on a 3-D mesh, "data" alone otherwise; under FSDP, "embed" claims the data
   axes too (ZeRO: params and optimizer state shard over data).
2. *Fallback* claims second: "seq_kv" (and, via ``rules``, "seq") picks up
   the "model" axis only when no primary claimer used it — sequence
   parallelism kicks in exactly when heads/ff could not shard.
3. A dimension that does not divide the claimed axes' product stays
   unsharded, and no mesh axis is ever assigned twice within one spec.

The meshes are the port's own (``launch.mesh``): a :class:`ModelMesh` —
``make_production_mesh`` (logical, on the ``meta`` device) or
``make_host_mesh`` — or an :class:`ArrayMesh` (one axis, ``"array"``, of
``n_arrays``). :class:`PartitionSpec` is a tuple whose entries are ``None``,
an axis name or a tuple of axis names, as the reference's; a
:class:`NamedSharding` pairs it with its mesh and answers the shard shape
and bytes of a global shape.

Placement: on a mesh of one device without a process group tensors stay
plain and a :func:`hint` only computes its spec (an axes / rank mismatch
raises, as the reference's assert does), the identity, as
``with_sharding_constraint`` is on a one-device mesh. On a mesh under a
process group (``launch.mesh.init_distributed``; one rank included) tensors
are DTensors over the mesh's ``DeviceMesh`` (``dist.placement``): a
:class:`NamedSharding` gives a spec's placements and places a tensor, and
inside :func:`use_sharding` a hint redistributes a DTensor to its spec. A
mesh over several positions without a group raises: one process a card.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch

from repro_torch._device import as_device
from repro_torch._tree import tree_map

# Mesh-axis claims. Each candidate is a tuple of mesh axes claimed *together*
# (the dimension shards over their size product). Candidates are tried in
# order; absent mesh axes are dropped from a candidate before trying it.
_MODEL = (("model",),)
# "array" is the 1-D pSRAM-array mesh axis (launch.mesh.make_array_mesh);
# batch-like dimensions claim it exactly like the data axes, so
# sparse.arrays_for_mesh answers from the same rule set. Meshes without an
# "array" axis drop the candidate before it is tried.
_DATA = (("pod", "data"), ("data",), ("array",))

# Tensor-parallel and batch-parallel logical names (primary claimers).
PRIMARY_CLAIMS = {
    "ff": _MODEL,
    "qdim": _MODEL,
    "kvdim": _MODEL,
    "heads": _MODEL,
    "kv_heads": _MODEL,
    "experts": _MODEL,
    "vocab": _MODEL,
    "batch": _DATA,
}

# Names that claim the data axes only under FSDP (ZeRO parameter sharding).
FSDP_CLAIMS = {"embed": _DATA}

# Built-in fallback rules: {logical name: (fallback claims, primary claims)}.
# "seq_kv" always opts into KV-cache sequence parallelism; activations' "seq"
# opts in via the --seq-shard rule, e.g. rules={"seq": (("model",), ())}.
DEFAULT_RULES = {"seq_kv": (("model",), ())}


class PartitionSpec(tuple):
    """Per-dimension mesh axes: ``None`` (replicated), an axis name, or a
    tuple of axis names claimed together."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _axis_sizes(mesh) -> dict:
    if hasattr(mesh, "n_arrays"):  # launch.mesh.ArrayMesh
        return {"array": mesh.n_arrays}
    return dict(zip(mesh.axis_names, mesh.shape))


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placement_device(mesh, what: str = "this mesh") -> torch.device:
    """This process's device on ``mesh``: ``meta`` for a logical mesh, the
    one device of a one-device mesh, this rank's device on a mesh under a
    process group. A model mesh over several positions without a group
    raises (one process a card); an array mesh over several cards places its
    shards itself (``sparse.mesh``) and raises here."""
    if hasattr(mesh, "n_arrays"):
        real = {d for d in mesh.devices if d.type != "meta"}
        if len(real) > 1:
            raise ValueError(f"{what} is an array mesh over {len(real)} devices: "
                             "sparse.mesh places its shards array by array")
        return real.pop() if real else torch.device("meta")
    if not mesh.logical:
        mesh.placed  # the pointed error of several positions without a group
    return mesh.local_device()


def mesh_device(mesh, device, what: str) -> torch.device:
    """The device an engine on ``mesh`` runs on: this process's device on
    the mesh, which ``device`` may name again; ``device`` alone without a
    mesh; the card when neither is given."""
    if mesh is None:
        return as_device("cuda" if device is None else device)
    where = placement_device(mesh, f"{what}'s mesh")
    if where.type == "meta":
        raise ValueError(f"{what} runs on a mesh of real devices; a production mesh is "
                         "logical (the dry run prices it)")
    if device is not None:
        asked = as_device(device)
        if asked.type == "cuda" and asked.index is None:
            asked = torch.device("cuda", torch.cuda.current_device())
        if asked != where:
            raise ValueError(f"{what}: device {device} is not the mesh's device {where}")
    return where


class NamedSharding:
    """A :class:`PartitionSpec` on a mesh: the counterpart of
    ``jax.sharding.NamedSharding`` for shapes and bytes."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __repr__(self):
        return f"NamedSharding({self.spec!r})"

    @property
    def device(self) -> torch.device:
        """Where this process's block of a tensor with this sharding lives
        (:func:`placement_device`)."""
        return placement_device(self.mesh, "this sharding's mesh")

    @property
    def placements(self) -> tuple:
        """The DTensor placements of the spec on the mesh's axes."""
        from .placement import placements
        return placements(self.spec, self.mesh.axis_names)

    def distribute(self, t: torch.Tensor):
        """``t`` (the whole tensor, the same on every rank) placed with this
        sharding: a DTensor on a mesh under a process group, else ``t`` on
        the mesh's device."""
        if getattr(self.mesh, "placed", False):
            from .placement import distribute
            return distribute(t.to(self.device), self.mesh, self.spec)
        return t.to(self.device)

    def shard_shape(self, global_shape) -> tuple[int, ...]:
        """Each device's block of a tensor of ``global_shape``."""
        global_shape = tuple(global_shape)
        if len(self.spec) > len(global_shape):
            raise ValueError(f"spec {self.spec} has more entries than shape {global_shape}")
        sizes = _axis_sizes(self.mesh)
        out = list(global_shape)
        for i, entry in enumerate(self.spec):
            n = math.prod(sizes[a] for a in _entry_axes(entry))
            if out[i] % n:
                raise ValueError(f"dimension {i} of {global_shape} does not divide "
                                 f"over {entry} ({n})")
            out[i] //= n
        return tuple(out)

    def shard_bytes(self, global_shape, dtype) -> int:
        """Bytes of one device's block of a ``dtype`` tensor of
        ``global_shape``."""
        itemsize = torch.empty((), dtype=dtype, device="meta").element_size()
        return math.prod(self.shard_shape(global_shape)) * itemsize


def _normalize(cand, sizes):
    """A claim entry may be one axis name or a tuple of names; keep only the
    axes this mesh actually has."""
    cand = (cand,) if isinstance(cand, str) else tuple(cand)
    return tuple(a for a in cand if a in sizes)


def _try_claim(dim, cand, sizes, used):
    """Claim ``cand`` for a dimension of size ``dim`` if every axis is free
    and ``dim`` divides their product; returns the claimed tuple or None."""
    if not cand or any(a in used for a in cand):
        return None
    prod = math.prod(sizes[a] for a in cand)
    if dim % prod != 0:
        return None
    used.update(cand)
    return cand


def _merged_rules(rules):
    merged = dict(DEFAULT_RULES)
    merged.update(rules or {})
    return merged


def logical_to_spec(axes, shape, mesh, fsdp: bool = False, rules=None) -> PartitionSpec:
    """The :class:`PartitionSpec` of a tensor with logical ``axes`` / ``shape``.

    ``axes`` entries are logical names or None (never sharded); ``rules``
    maps logical names to ``(fallback_claims, primary_claims)`` tuples and
    overrides / extends :data:`DEFAULT_RULES`.
    """
    axes = tuple(axes)
    shape = tuple(shape)
    if len(axes) != len(shape):
        raise ValueError(f"logical axes {axes} and shape {shape} differ in rank")
    sizes = _axis_sizes(mesh)
    merged = _merged_rules(rules)
    assigned: list[tuple | None] = [None] * len(axes)
    used: set[str] = set()

    def claims_for(name):
        out = []
        if name in merged:
            out.extend(merged[name][1])  # rule-provided primary claims
        out.extend(PRIMARY_CLAIMS.get(name, ()))
        if fsdp:
            out.extend(FSDP_CLAIMS.get(name, ()))
        return out

    # pass 1: primary claims, position order
    for i, (name, dim) in enumerate(zip(axes, shape)):
        if name is None:
            continue
        seen = set()
        for cand in claims_for(name):
            cand = _normalize(cand, sizes)
            if cand in seen:
                continue
            seen.add(cand)
            got = _try_claim(dim, cand, sizes, used)
            if got:
                assigned[i] = got
                break

    # pass 2: fallback claims pick up leftover axes (sequence parallelism)
    for i, (name, dim) in enumerate(zip(axes, shape)):
        if assigned[i] is not None or name is None or name not in merged:
            continue
        for cand in merged[name][0]:
            got = _try_claim(dim, _normalize(cand, sizes), sizes, used)
            if got:
                assigned[i] = got
                break

    return PartitionSpec(*(a[0] if a and len(a) == 1 else a for a in assigned))


def tree_shardings(structs, specs, mesh, fsdp: bool = False, rules=None):
    """:class:`NamedSharding` leaves for a tree of tensors (or ``meta``
    twins) and its logical-spec tree (``specs_of`` / ``param_specs`` /
    ``state_spec_tree``: a tuple of logical names at each leaf)."""
    def one(s, ax):
        return NamedSharding(mesh, logical_to_spec(tuple(ax), s.shape, mesh, fsdp, rules))

    return tree_map(one, structs, specs)


# ---------------------------------------------------------------------------
# FSDP heuristic
# ---------------------------------------------------------------------------

# Bytes per parameter resident on a device. Serving keeps bf16 weights only;
# training adds the f32 master copy and both f32 Adam moments.
SERVE_BYTES_PER_PARAM = 2
TRAIN_BYTES_PER_PARAM = 2 + 4 + 4 + 4
# Shard over data when tensor parallelism alone leaves more than this per
# device. The reference's 10e9 is 10 GB of a 16 GB HBM part (62.5%, the rest
# headroom for activations); the same share of an H100's 80 GB of HBM3 is
# 0.625 * 80e9 = 50e9 bytes.
FSDP_THRESHOLD_BYTES = 50e9


def estimate_fsdp(param_count: int, mesh, training: bool = False) -> bool:
    """Should this model train / serve with FSDP on this mesh?

    With tensor parallelism only, params (and in training the optimizer
    state) replicate over the data axes; per-device bytes are
    ``param_count * bytes_per_param / model_axis_size``. Above the HBM
    headroom threshold the data axes must shard them too (ZeRO/FSDP).
    """
    model = _axis_sizes(mesh).get("model", 1)
    bpp = TRAIN_BYTES_PER_PARAM if training else SERVE_BYTES_PER_PARAM
    return param_count * bpp / model > FSDP_THRESHOLD_BYTES


# ---------------------------------------------------------------------------
# hint() and the sharding context
# ---------------------------------------------------------------------------

class _Ctx(threading.local):
    def __init__(self):
        self.stack: list[tuple] = []


_ctx = _Ctx()


@contextlib.contextmanager
def use_sharding(mesh, fsdp: bool = False, rules=None):
    """Activate logical-axis constraints: inside this context :func:`hint`
    computes the spec :func:`logical_to_spec` gives (and moves a DTensor
    there); outside it, hints are no-ops. A mesh over several positions
    without a process group raises (one process a card)."""
    placement_device(mesh, "use_sharding's mesh")
    # specs by (axes, shape): a hint costs one dict lookup after its first call
    _ctx.stack.append((mesh, fsdp, rules, {}))
    try:
        if getattr(mesh, "placed", False):
            # plain tensors the models make (masks, positions) meet DTensors
            # as replicated ones
            from torch.distributed.tensor.experimental import implicit_replication
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _ctx.stack.pop()


def active_spec(shape, *axes) -> PartitionSpec | None:
    """The spec the active :func:`use_sharding` context gives a tensor of
    ``shape`` with logical ``axes`` (a tuple or varargs); None outside."""
    if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
        axes = tuple(axes[0])
    if not _ctx.stack:
        return None
    mesh, fsdp, rules, cache = _ctx.stack[-1]
    key = (axes, tuple(shape))
    spec = cache.get(key)
    if spec is None:
        spec = cache[key] = logical_to_spec(axes, shape, mesh, fsdp, rules)
    return spec


def hint(x, *axes):
    """Annotate ``x`` with logical axis names (a tuple or varargs).

    ``x`` itself outside a :func:`use_sharding` context. Inside, the spec is
    computed (an axes / shape mismatch raises); a DTensor is redistributed
    to it (a no-op where it is there), the counterpart of
    ``with_sharding_constraint``; a plain tensor — one device, or a local
    block inside a kernel's region — is returned as it is."""
    if _ctx.stack:
        spec = active_spec(x.shape, *axes)
        if type(x) is not torch.Tensor:
            from .placement import is_dtensor, redistribute
            if is_dtensor(x):
                return redistribute(x, _ctx.stack[-1][0], spec)
    return x
