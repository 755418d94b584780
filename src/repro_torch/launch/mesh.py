"""The meshes: which devices host a model's shards or the pSRAM arrays.

A model mesh is the small frozen :class:`ModelMesh`: axis names, a shape,
and one device a position. :func:`make_production_mesh` gives the
reference's ``(16, 16)`` ``("data", "model")`` mesh, or ``(2, 16, 16)``
``("pod", "data", "model")``, as a *logical* mesh on the ``meta`` device (the
counterpart of the reference's 512 forced host devices: no device state is
touched, nothing is allocated); ``dist.sharding`` computes its specs and
shard shapes, and the dry run prices them. :func:`make_host_mesh` lays
``(n // model, model)`` over the visible devices of one type.


The reference lays its arrays on a 1-D ``jax.sharding.Mesh`` with one axis,
``"array"``, one device per array. The port's counterpart is the small frozen
:class:`ArrayMesh`: the number of arrays, the devices that host them, and
the order the arrays run in. Arrays are placed round-robin over the
devices, so on one card the shards run in turn on that card (a looped
launch), and on ``k`` cards array ``a`` runs on card ``a % k``.

One departure from the reference: more arrays than devices is allowed, and
those arrays share a device. A pSRAM array is not a card; the reference's
``ValueError`` there only asks for more emulated CPU devices.

Shards are placed on one device: a model mesh over several distinct cards
is accepted here and refused where it would be placed (``dist.sharding``,
ROADMAP Queue A item 9c).
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ModelMesh:
    """A model mesh: ``axis_names``, ``shape`` and the ``devices`` at its
    positions, row-major (``math.prod(shape)`` of them)."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    devices: tuple[torch.device, ...]

    def __post_init__(self):
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "shape", tuple(int(n) for n in self.shape))
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} and shape {self.shape} differ in rank")
        if len(self.devices) != math.prod(self.shape):
            raise ValueError(f"a {self.shape} mesh needs {math.prod(self.shape)} devices, "
                             f"got {len(self.devices)}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(multi_pod: bool = False) -> ModelMesh:
    """The reference's production mesh, logical, on the ``meta`` device:
    ``(16, 16)`` ``("data", "model")``, or ``(2, 16, 16)`` ``("pod", "data",
    "model")`` with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return ModelMesh(axes, shape, (torch.device("meta"),) * math.prod(shape))


def make_host_mesh(model: int = 1, device: str | torch.device = "cuda") -> ModelMesh:
    """``(n // model, model)`` ``("data", "model")`` over the ``n`` visible
    devices of ``device``'s type (the cards by default: raises without one;
    ``"cpu"`` is one device). Raises where ``model`` does not divide ``n``."""
    devs = visible_devices(device)
    n = len(devs)
    if model < 1 or n % model:
        raise ValueError(f"model axis {model} does not divide the {n} visible "
                         f"{torch.device(device).type} device(s)")
    return ModelMesh(("data", "model"), (n // model, model), devs)


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
