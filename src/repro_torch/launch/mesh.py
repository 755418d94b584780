"""The meshes: which devices host a model's shards or the pSRAM arrays.

A model mesh is the small frozen :class:`ModelMesh`: axis names, a shape,
and one device a position. :func:`make_production_mesh` gives the
reference's ``(16, 16)`` ``("data", "model")`` mesh, or ``(2, 16, 16)``
``("pod", "data", "model")``, as a *logical* mesh on the ``meta`` device (the
counterpart of the reference's 512 forced host devices: no device state is
touched, nothing is allocated); ``dist.sharding`` computes its specs and
shard shapes, and the dry run prices them. :func:`make_host_mesh` lays
``(n // model, model)`` over the ranks of the process group (one process a
card, :func:`init_distributed`), or over this process's one device when no
group is up.

A model mesh over several ranks is a ``torch.distributed`` ``DeviceMesh``
(:meth:`ModelMesh.device_mesh`, built with the mesh's ``axis_names``):
``dist.sharding`` places parameters, optimizer state, caches and batches on
it as DTensors. Position ``i`` of the mesh is rank ``ranks[i]``, which runs
on ``devices[i]``; four gloo ranks all on ``cpu`` are a mesh too. A mesh
over several cards in one process without a group raises
(:func:`require_group`): one process a card.


The reference lays its arrays on a 1-D ``jax.sharding.Mesh`` with one axis,
``"array"``, one device per array. The port's counterpart is the small frozen
:class:`ArrayMesh`: the number of arrays, the devices that host them, and
the order the arrays run in. Arrays are placed round-robin over the
devices, so on one card the shards run in turn on that card (a looped
launch), and on ``k`` cards array ``a`` runs on card ``a % k``.

One departure from the reference: more arrays than devices is allowed, and
those arrays share a device. A pSRAM array is not a card; the reference's
``ValueError`` there only asks for more emulated CPU devices.

The array mesh stays in one process: its arrays run round-robin over the
visible cards of that process (``sparse.mesh``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os

import torch
import torch.distributed as dist

#: the pointed error of a mesh over several positions without a process group
ONE_PROCESS_A_CARD = ("one process a card: torchrun or `init_distributed` (launch.mesh) "
                      "before a mesh spans several ranks")


def init_distributed(device: str | torch.device = "cuda", init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None) -> int:
    """Join the process group torchrun describes and return this rank.

    Reads ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
    ``MASTER_PORT`` (``rank`` / ``world_size`` / ``init_method`` override
    them, e.g. a ``file://`` store); NCCL on ``cuda``, after
    ``torch.cuda.set_device(LOCAL_RANK)``, gloo on ``cpu``. A group already
    up is kept."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device='cuda') needs a CUDA device and none "
                               "is visible; pass device='cpu' for gloo on the CPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if dist.is_initialized():
        return dist.get_rank()
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else int(world_size)
    if init_method is None:
        init_method = (f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}")
    dist.init_process_group("nccl" if kind == "cuda" else "gloo", init_method=init_method,
                            rank=rank, world_size=world_size)
    forget_meshes()
    return rank


def forget_meshes() -> None:
    """Drop what was decided for the meshes of an earlier process group: the
    ``DeviceMesh`` of each :class:`ModelMesh`, and DTensor's cache of
    sharding decisions, which keys on meshes that compare equal across
    groups and would hand back specs holding a dead group's sub-groups."""
    _device_mesh.cache_clear()
    from torch.distributed.tensor import DTensor
    cache = DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding
    if hasattr(cache, "cache_clear"):
        cache.cache_clear()


def world() -> int:
    """The process group's size, or 0 where none is up."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0


def rank_device(device: str | torch.device = "cuda") -> torch.device:
    """This process's device of ``device``'s type: ``cuda:LOCAL_RANK`` (the
    current card) or the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh on 'cuda' needs a CUDA device and none is "
                               "visible; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    if kind == "cpu":
        return torch.device("cpu")
    raise ValueError(f"no mesh over device type {kind!r}")


def require_group(size: int, what: str = "this mesh") -> None:
    """Raise unless a process group of ``size`` ranks is up."""
    if world() != size:
        have = f"a group of {world()}" if world() else "no process group"
        raise RuntimeError(f"{what} spans {size} ranks and this process has {have}: "
                           f"{ONE_PROCESS_A_CARD}")


@functools.lru_cache(maxsize=None)
def _device_mesh(kind: str, shape: tuple, names: tuple, ranks: tuple):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(kind, torch.tensor(ranks).reshape(shape), mesh_dim_names=names)


@dataclasses.dataclass(frozen=True)
class ModelMesh:
    """A model mesh: ``axis_names``, ``shape``, the ``devices`` at its
    positions, row-major (``math.prod(shape)`` of them), and the process
    group ``ranks`` that hold them (``None``: ranks ``0 .. size - 1``)."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    devices: tuple[torch.device, ...]
    ranks: tuple[int, ...] | None = None

    def __post_init__(self):
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "shape", tuple(int(n) for n in self.shape))
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} and shape {self.shape} differ in rank")
        if len(self.devices) != math.prod(self.shape):
            raise ValueError(f"a {self.shape} mesh needs {math.prod(self.shape)} devices, "
                             f"got {len(self.devices)}")
        ranks = tuple(range(self.size)) if self.ranks is None else tuple(map(int, self.ranks))
        if sorted(ranks) != list(range(self.size)):
            raise ValueError(f"ranks {ranks} are not the {self.size} ranks of the mesh")
        object.__setattr__(self, "ranks", ranks)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def logical(self) -> bool:
        """A mesh on ``meta``: priced, never placed."""
        return all(d.type == "meta" for d in self.devices)

    @property
    def placed(self) -> bool:
        """Whether tensors on this mesh are DTensors: a mesh of real devices
        under a process group of its size (one rank included). Without a
        group a one-position mesh holds plain tensors; several positions
        raise (:func:`require_group`)."""
        if self.logical:
            return False
        if world() == 0 and self.size == 1:
            return False
        require_group(self.size, f"a {self.shape} mesh over {sorted(set(map(str, self.devices)))}")
        return True

    def device_mesh(self):
        """The ``DeviceMesh`` of the ranks (:attr:`placed` meshes only)."""
        if not self.placed:
            raise ValueError("a DeviceMesh needs a mesh of real devices under a process group")
        kind = self.devices[0].type
        return _device_mesh(kind, self.shape, self.axis_names, self.ranks)

    def local_device(self) -> torch.device:
        """This process's device on the mesh."""
        if self.logical:
            return torch.device("meta")
        if world() == 0:
            if self.size > 1:
                require_group(self.size, f"a {self.shape} mesh")
            return self.devices[0]
        return self.devices[self.ranks.index(dist.get_rank())]


@dataclasses.dataclass(frozen=True)
class FakeMesh(ModelMesh):
    """A logical mesh under torch's ``fake`` process group
    (``launch.roofline.fake_world``): its tensors are DTensors on ``meta``
    over the ``fake`` ``DeviceMesh``, and its collectives move nothing."""

    fake: object = None

    @property
    def placed(self) -> bool:
        return True

    def device_mesh(self):
        return self.fake

    def local_device(self) -> torch.device:
        return torch.device("meta")


def make_production_mesh(multi_pod: bool = False) -> ModelMesh:
    """The reference's production mesh, logical, on the ``meta`` device:
    ``(16, 16)`` ``("data", "model")``, or ``(2, 16, 16)`` ``("pod", "data",
    "model")`` with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return ModelMesh(axes, shape, (torch.device("meta"),) * math.prod(shape))


def make_host_mesh(model: int = 1, device: str | torch.device = "cuda") -> ModelMesh:
    """``(n // model, model)`` ``("data", "model")`` over the ``n`` ranks of
    the process group, rank ``r`` at position ``r`` on its own device of
    ``device``'s type (``cuda:LOCAL_RANK``, or the CPU); without a group over
    this process's one device (the current card by default: raises without
    one; ``"cpu"``). Raises where ``model`` does not divide ``n``."""
    kind = torch.device(device).type
    here = rank_device(kind)
    n = world() or 1
    if model < 1 or n % model:
        raise ValueError(f"model axis {model} does not divide the {n} "
                         f"{'ranks' if world() else kind + ' device'}")
    if world():
        devs = [None] * n
        for r, d in enumerate(_gather_devices(here)):
            devs[r] = d
    else:
        devs = [here]
    return ModelMesh(("data", "model"), (n // model, model), tuple(devs))


def _gather_devices(here: torch.device) -> list[torch.device]:
    """Every rank's device, by rank (one ``all_gather_object``)."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, str(here))
    return [torch.device(d) for d in out]


@dataclasses.dataclass(frozen=True)
class ArrayMesh:
    """``n_arrays`` pSRAM arrays over ``devices`` (round-robin). ``order`` is
    the order the arrays run in and their partial outputs are added (the
    all-reduce's ring order); ``None`` is ascending array id."""

    n_arrays: int
    devices: tuple[torch.device, ...]
    order: tuple[int, ...] | None = None

    axis_names = ("array",)

    def __post_init__(self):
        if self.n_arrays < 1:
            raise ValueError("need at least one array")
        if not self.devices:
            raise ValueError("an array mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))
        if len({d.type for d in self.devices}) != 1:
            raise ValueError(f"the devices of an array mesh share one type, got {self.devices}")
        if self.order is not None:
            order = tuple(int(a) for a in self.order)
            if sorted(order) != list(range(self.n_arrays)):
                raise ValueError(f"order {order} is not a permutation of the "
                                 f"{self.n_arrays} arrays")
            object.__setattr__(self, "order", order)

    def device_of(self, array_id: int) -> torch.device:
        """The device that runs array ``array_id``."""
        return self.devices[array_id % len(self.devices)]

    def run_order(self) -> tuple[int, ...]:
        return self.order if self.order is not None else tuple(range(self.n_arrays))


def visible_devices(device: str | torch.device = "cuda") -> tuple[torch.device, ...]:
    """Every visible device of ``device``'s type: the CUDA cards (raising
    where there is none), or the one CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh on 'cuda' needs a CUDA device and none is "
                               "visible; pass device='cpu' to run on the CPU")
        return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    if kind == "cpu":
        return (torch.device("cpu"),)
    raise ValueError(f"no mesh over device type {kind!r}")


def make_array_mesh(n_arrays: int | None = None,
                    device: str | torch.device = "cuda") -> ArrayMesh:
    """A 1-D mesh of ``n_arrays`` pSRAM arrays over every visible device of
    ``device``'s type (``"cuda"`` by default: raises without a card;
    ``"cpu"`` asks for the CPU). ``n_arrays=None`` means one array per
    device, as in the reference; ``n_arrays < 1`` raises. A ``device`` with
    an index (``"cuda:1"``) hosts every array itself."""
    dev = torch.device(device)
    devs = visible_devices(dev)
    if dev.index is not None:
        if dev not in devs:
            raise ValueError(f"device {dev} is not visible; visible: {devs}")
        devs = (dev,)
    n = len(devs) if n_arrays is None else int(n_arrays)
    if n < 1:
        raise ValueError("need at least one array")
    return ArrayMesh(n_arrays=n, devices=devs[:n])


def chips(mesh: ArrayMesh | ModelMesh) -> int:
    """How many devices a model mesh has (its positions), or how many devices
    an array mesh's arrays run on."""
    if isinstance(mesh, ModelMesh):
        return mesh.size
    return min(mesh.n_arrays, len(mesh.devices))
