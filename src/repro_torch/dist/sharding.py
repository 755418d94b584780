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

Placement is on one device. Under :func:`use_sharding` a :func:`hint`
computes its spec (so an axes / shape mismatch raises, as the reference's
assert does) and returns the tensor itself: on a mesh whose devices are one
device, or ``meta``, the constraint is the identity, as
``with_sharding_constraint`` is on a one-device mesh. So on one device a
hint only checks its axes against the tensor's rank: no code reads the
activation specs it computes until placement across several cards (ROADMAP
Queue A item 9c), where a mesh over several distinct cards raises
``NotImplementedError`` today.
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

#: the ROADMAP item that places a mesh over several cards
MULTI_CARD_ITEM = "ROADMAP Queue A item 9c"


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
    """The one device that a mesh's shards live on: its only real device, or
    ``meta`` for a logical mesh. A mesh over several distinct real devices
    raises (:data:`MULTI_CARD_ITEM`)."""
    real = {d for d in mesh.devices if d.type != "meta"}
    if len(real) > 1:
        raise NotImplementedError(
            f"{what} spans {len(real)} distinct devices ({sorted(map(str, real))}); placement "
            f"across several cards comes with {MULTI_CARD_ITEM} (DTensor over a DeviceMesh)")
    return real.pop() if real else torch.device("meta")


def mesh_device(mesh, device, what: str) -> torch.device:
    """The device an engine on ``mesh`` runs on: the mesh's one real device
    (several cards raise), which ``device`` may name again; ``device`` alone
    without a mesh; the card when neither is given."""
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
        """Where a tensor with this sharding lives (:func:`placement_device`)."""
        return placement_device(self.mesh, "this sharding's mesh")

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
    computes the spec :func:`logical_to_spec` gives; outside it, hints are
    no-ops. A mesh over several distinct cards raises
    (:data:`MULTI_CARD_ITEM`)."""
    placement_device(mesh, "use_sharding's mesh")
    # specs by (axes, shape): a hint costs one dict lookup after its first call
    _ctx.stack.append((mesh, fsdp, rules, {}))
    try:
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
    computed (an axes / shape mismatch raises) and ``x`` is returned: the
    context's mesh lives on one device, where the constraint is the
    identity, so the hint is a rank check until ROADMAP item 9c places
    activations by their specs."""
    if _ctx.stack:
        active_spec(x.shape, *axes)
    return x
