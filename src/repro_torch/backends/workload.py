"""Workload normalization for the backend registry.

One ``Workload`` union flows through ``repro_torch.api`` and every backend:

* **descriptors** (shape only, for ``cost``/``estimate``):
  :class:`~repro_torch.core.perf_model.MTTKRPWorkload` (dense, §V-A),
  :class:`~repro_torch.core.perf_model.SparseMTTKRPWorkload` (fiber-length
  distribution), and :class:`MatmulWorkload` (one projection-shaped matmul).
* **instances** (data + factors, for ``execute``): a dense tensor, a raw COO
  triple ``(indices, values, shape)``, or any ``repro_torch.sparse.formats``
  container — optionally wrapped with its factors/mode in
  :class:`MTTKRPProblem`.

:func:`normalize_mttkrp_data` tags the data union once so every backend
shares one dispatch; :func:`describe` turns an instance into the matching
cost descriptor so ``api.estimate(workload)`` accepts either form.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


@dataclasses.dataclass(frozen=True)
class MatmulWorkload:
    """One ``(M,K) @ (K,N)`` matmul, repeated ``repeats`` times."""

    m: int
    k: int
    n: int
    repeats: int = 1

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n * self.repeats


@dataclasses.dataclass(frozen=True)
class MTTKRPProblem:
    """An executable MTTKRP: data + factors + target mode.

    ``data`` is a dense tensor, a COO triple, or a sparse container; this is
    the one-argument form ``api.execute`` takes.
    """

    data: Any
    factors: tuple
    mode: int = 0


def _is_sparse_container(obj) -> bool:
    from repro_torch.sparse.formats import COO, CSF

    return isinstance(obj, (COO, CSF))


def _is_coo_triple(obj) -> bool:
    return (
        isinstance(obj, tuple)
        and len(obj) == 3
        and hasattr(obj[0], "ndim")
        and hasattr(obj[1], "ndim")
        and isinstance(obj[2], (tuple, list))
    )


@dataclasses.dataclass(frozen=True)
class NormalizedMTTKRP:
    """Tagged data union every backend dispatches over.

    ``kind`` is ``"dense"`` | ``"coo"`` | ``"container"``. For ``"coo"``,
    ``indices``/``values``/``shape`` are set; for ``"container"``,
    ``container`` holds the original object (a CSF already rooted at the
    target mode is used as-is — that is how ``cp_als`` reuses its per-mode
    CSF cache through a backend).
    """

    kind: str
    dense: Any = None
    indices: Any = None
    values: Any = None
    shape: tuple | None = None
    container: Any = None


def normalize_mttkrp_data(data) -> NormalizedMTTKRP:
    if _is_sparse_container(data):
        return NormalizedMTTKRP(kind="container", container=data,
                                shape=tuple(data.shape))
    if _is_coo_triple(data):
        idx, vals, shape = data
        return NormalizedMTTKRP(kind="coo", indices=idx, values=vals,
                                shape=tuple(int(s) for s in shape))
    if hasattr(data, "ndim") and hasattr(data, "shape"):
        return NormalizedMTTKRP(kind="dense", dense=data,
                                shape=tuple(int(s) for s in data.shape))
    raise TypeError(
        "MTTKRP data must be a dense tensor, a (indices, values, shape) COO "
        f"triple, or a repro_torch.sparse container — got {type(data).__name__}"
    )


def to_coo_triple(norm: NormalizedMTTKRP):
    """Any normalized data as a concrete COO triple."""
    if norm.kind == "coo":
        return norm.indices, norm.values, norm.shape
    if norm.kind == "container":
        from repro_torch.sparse.formats import CSF

        c = norm.container
        base = c.to_coo() if isinstance(c, CSF) else c
        return base.indices, base.values, tuple(base.shape)
    from repro_torch.core.mttkrp import dense_to_coo

    idx, vals = dense_to_coo(norm.dense)
    return idx, vals, norm.shape


def mode_csf(norm: NormalizedMTTKRP, mode: int):
    """A CSF rooted at ``mode`` for any normalized data (reuses an already
    correctly-rooted CSF instead of re-sorting)."""
    from repro_torch.sparse.formats import COO, CSF, csf_for_mode

    if norm.kind == "container" and isinstance(norm.container, CSF) \
            and norm.container.mode_order[0] == mode:
        return norm.container
    idx, vals, shape = to_coo_triple(norm)
    return csf_for_mode(COO(indices=idx, values=vals, shape=tuple(shape)), mode)


def describe(workload, rank: int | None = None, mode: int = 0):
    """Turn any member of the Workload union into a *cost descriptor*.

    Descriptors (``MTTKRPWorkload`` / ``SparseMTTKRPWorkload`` /
    ``MatmulWorkload``) pass through; executable instances are summarized —
    a 3-mode dense tensor becomes its ``MTTKRPWorkload`` dims, sparse data
    becomes the ``SparseMTTKRPWorkload`` of its mode-rooted fiber-length
    distribution (the quantity the sparse model is defined over). ``rank``
    is required when it cannot be read off the workload itself.
    """
    from repro_torch.core.perf_model import MTTKRPWorkload, SparseMTTKRPWorkload

    if isinstance(workload, (MTTKRPWorkload, SparseMTTKRPWorkload,
                             MatmulWorkload)):
        return workload
    if isinstance(workload, MTTKRPProblem):
        rank = rank or int(workload.factors[0].shape[-1])
        mode = workload.mode
        workload = workload.data
    norm = normalize_mttkrp_data(workload)
    if rank is None:
        raise ValueError(
            "rank is required to describe raw tensor data (pass rank=, or a "
            "MTTKRPProblem whose factors carry it)"
        )
    if norm.kind == "dense":
        if len(norm.shape) != 3:
            raise ValueError(
                f"dense cost descriptor is 3-mode (got shape {norm.shape}); "
                "pass a SparseMTTKRPWorkload for N-mode data"
            )
        i, j, k = norm.shape
        return MTTKRPWorkload(i=i, j=j, k=k, rank=rank)
    fibers = mode_csf(norm, mode).fiber_lengths()
    return SparseMTTKRPWorkload(fiber_lengths=np.asarray(fibers), rank=rank)
