"""The array mesh: which devices host the pSRAM arrays of a run.

The reference lays its arrays on a 1-D ``jax.sharding.Mesh`` with one axis,
``"array"``, one device per array. The port's counterpart is the small frozen
:class:`ArrayMesh`: the number of arrays, the devices that host them, and
the order the arrays run in. Arrays are placed round-robin over the
devices, so on one card the shards run in turn on that card (a looped
launch), and on ``k`` cards array ``a`` runs on card ``a % k``.

One departure from the reference: more arrays than devices is allowed, and
those arrays share a device. A pSRAM array is not a card; the reference's
``ValueError`` there only asks for more emulated CPU devices.

``make_production_mesh`` and ``make_host_mesh`` (the model meshes) come with
``dist/`` (ROADMAP Queue A item 9).
"""
from __future__ import annotations

import dataclasses

import torch


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
            raise RuntimeError("an array mesh on 'cuda' needs a CUDA device and none is "
                               "visible; pass device='cpu' to run the arrays on the CPU")
        return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    if kind == "cpu":
        return (torch.device("cpu"),)
    raise ValueError(f"no array mesh over device type {kind!r}")


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


def chips(mesh: ArrayMesh) -> int:
    """How many devices the mesh's arrays run on."""
    return min(mesh.n_arrays, len(mesh.devices))
