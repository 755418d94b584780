"""Ordered fold — the exact sparse MTTKRP's CP3 scatter, in stream order.

For a stream of contributions ``d (n, R)`` whose target rows ``ids (n,)`` are
sorted non-decreasing,

    out[row] = ((out[row] + d[i0]) + d[i0 + 1]) + ...   over the row's run,

one rounded f32 add a contribution, starting from the row's current value —
so chunked calls over one stream compose into one in-order fold, the
reference's ``out.at[r_b].add(d)`` per chunk. Fed a stably sorted stream it
is also the fold order of one global ``jax.ops.segment_sum`` over the
unsorted one, which is what the reference's exact sparse paths assert
bit-identity to (``src/repro/core/mttkrp.py:mttkrp_sparse``,
``src/repro/sparse/stream.py``'s eager executor).

The hand-written Hopper kernel lives in ``csrc/ordered_fold.cu`` (CUDA C++,
``sm_90a``). It replaces no TPU kernel: the reference leaves the scatter to
XLA, which adds in stream order; on the card PyTorch's ``index_add_`` is
atomic and unordered, so the port needs a kernel to keep the order. One CTA
per run streams the run's rows through a shared-memory ring, and one warp
adds them in order. Bound by bytes, and for a long run by its chain of
dependent adds — see the source note.

:func:`ordered_fold` is the wrapper: for CUDA tensors it launches the kernel
(or raises); for CPU tensors — and only because they lie on the CPU — it uses
:func:`ordered_fold_torch`, one ``index_add_``, which on the CPU adds in
stream order. The two are **bit-equal**.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build


def _check(out, d, ids):
    if out.ndim != 2 or d.ndim != 2 or ids.ndim != 1:
        raise ValueError(f"out must be (rows, R), d (n, R) and ids (n,); got "
                         f"{tuple(out.shape)}, {tuple(d.shape)}, {tuple(ids.shape)}")
    if d.shape[1] != out.shape[1] or ids.shape[0] != d.shape[0]:
        raise ValueError(f"d {tuple(d.shape)} does not match out {tuple(out.shape)} "
                         f"and ids {tuple(ids.shape)}")
    if out.dtype != torch.float32 or d.dtype != torch.float32:
        raise TypeError(f"out and d must be float32, got {out.dtype} / {d.dtype}")
    if len({out.device, d.device, ids.device}) != 1:
        raise ValueError("out, d and ids must live on one device")


def ordered_fold_torch(out: torch.Tensor, d: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``out.index_add_(0, ids, d)``, in place. On the
    CPU ``index_add_`` adds the contributions in stream order."""
    _check(out, d, ids)
    return out.index_add_(0, ids.long(), d)


def row_runs(ids: torch.Tensor, rows: int) -> torch.Tensor:
    """The runs of sorted ``ids`` as ``(rows + 1,)`` int64 stream offsets: row
    ``r`` owns positions ``[ptr[r], ptr[r+1])`` (empty where it has none)."""
    bounds = torch.arange(rows + 1, device=ids.device, dtype=torch.int64)
    return torch.searchsorted(ids.long().contiguous(), bounds)


def _entry():
    lib = _build.load("ordered_fold")
    fn = lib.ordered_fold_launch
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        lib.ordered_fold_max_rank.restype = ctypes.c_int
    return lib, fn


@functools.cache
def ordered_fold_max_rank() -> int:
    """The most rank columns the kernel takes, as the built library states it."""
    lib, _ = _entry()
    return lib.ordered_fold_max_rank()


def ordered_fold(out: torch.Tensor, d: torch.Tensor, ids: torch.Tensor,
                 runs: torch.Tensor | None = None) -> torch.Tensor:
    """``out[ids[i]] += d[i]`` for every ``i``, in stream order, in place;
    returns ``out``. ``ids`` must be sorted non-decreasing (the kernel takes
    each row's run as one contiguous block; it does not check).

    CUDA tensors go through one kernel launch on the current stream, without
    synchronizing; ``runs`` is :func:`row_runs` of ``ids`` where the caller
    keeps it (else it is formed here). CPU tensors go through
    :func:`ordered_fold_torch`."""
    _check(out, d, ids)
    if not out.is_cuda:
        return ordered_fold_torch(out, d, ids)
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    if runs is None:
        runs = row_runs(ids, out.shape[0])
    if (runs.dtype != torch.int64 or not runs.is_contiguous() or runs.device != out.device
            or runs.shape != (out.shape[0] + 1,)):
        raise ValueError(f"runs must be the ({out.shape[0] + 1},) int64 row_runs of ids "
                         f"on {out.device}")
    if out.shape[1] > ordered_fold_max_rank():
        raise ValueError(f"the ordered fold takes up to {ordered_fold_max_rank()} "
                         f"rank columns, got {out.shape[1]}")
    return _fold_runs(out, d.contiguous(), runs, None, 0, out.shape[0], 0)


def _fold_runs(out, d, seg_ptr, seg_rows, first: int, last: int, base: int) -> torch.Tensor:
    """One launch over segments ``[first, last)`` of precomputed runs:
    segment ``s`` folds ``d`` rows ``[seg_ptr[s] - base, seg_ptr[s+1] - base)``
    into row ``seg_rows[s]`` (row ``s`` where ``seg_rows`` is None). For
    callers that built the runs themselves, checked once where they were
    built (:func:`ordered_fold`, ``sparse.stream._fold_segments``): contiguous
    int64 on ``out``'s device, ``out`` and ``d`` contiguous f32 there."""
    lib, fn = _entry()
    vec = int(out.shape[1] % 4 == 0 and d.data_ptr() % 16 == 0)
    with torch.cuda.device(out.device):
        err = fn(out.data_ptr(), d.data_ptr(), seg_ptr.data_ptr() + 8 * first,
                 0 if seg_rows is None else seg_rows.data_ptr() + 8 * first, int(base),
                 last - first, out.shape[1], vec, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, lib, "ordered_fold")
    ordered_fold.launches += 1
    return out


#: kernel launches made by :func:`ordered_fold` (CUDA path only)
ordered_fold.launches = 0
