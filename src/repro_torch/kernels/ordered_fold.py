"""Ordered fold — the exact sparse MTTKRP's CP3 scatter, in stream order.

For a stream of contributions ``d (n, R)`` whose target rows ``ids (n,)`` are
sorted non-decreasing,

    out[row] = ((out[row] + d[i0]) + d[i0 + 1]) + ...   over the row's run,

one rounded f32 add a contribution, starting from the row's current value —
so calls over consecutive cuts of one stream compose into one in-order fold,
the reference's ``out.at[r_b].add(d)`` per chunk. Fed a stably sorted stream
it is also the fold order of one global ``jax.ops.segment_sum`` over the
unsorted one, which is what the reference's exact sparse paths assert
bit-identity to (``src/repro/core/mttkrp.py:mttkrp_sparse``,
``src/repro/sparse/stream.py``'s eager executor).

The hand-written Hopper kernels live in ``csrc/ordered_fold.cu`` (CUDA C++,
``sm_90a``). They replace no TPU kernel: the reference leaves the scatter to
XLA, which adds in stream order; on the card PyTorch's ``index_add_`` is
atomic and unordered, so the port needs a kernel to keep the order. Two
routes, counted in ``ordered_fold.routes``:

* ``"fold"`` — :func:`ordered_fold`: the contributions ``d`` are given. One
  CTA per run streams the run's rows through a shared-memory ring, and one
  warp adds them in order. The blocked path's partials fold through it.
* ``"chain"`` — :func:`ordered_chain_fold`: the contributions are formed in
  the kernel from the stream's non-target coordinates (:func:`chain_coords`),
  values and factors,
  ``d_p = v_p · ⊙ other-factor rows`` with ``cp_chain_exact``'s rounded
  multiplies, so a whole exact sparse MTTKRP is one launch and no ``(n, R)``
  temporary. One CTA per run: producer warps gather and multiply ahead of
  one warp that owns the chain of adds. Bound by the stream's bytes and the
  factor rows' L2 gathers, and for a long run by its chain of dependent adds
  — see the source note.

:func:`ordered_fold` launches its kernel for CUDA tensors (or raises) and,
for CPU tensors — only because they lie on the CPU — uses
:func:`ordered_fold_torch`, one ``index_add_``, which on the CPU adds in
stream order; the two are **bit-equal**. :func:`ordered_chain_fold` takes
CUDA tensors only: its callers keep their stepped CPU path (the chain in
steps of bounded temporaries, then ``index_add_``), and its plain version
:func:`ordered_chain_fold_torch` forms the whole stream's ``d`` at once.
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
    built (:func:`ordered_fold`, ``sparse.stream._segment_blocks``): contiguous
    int64 on ``out``'s device, ``out`` and ``d`` contiguous f32 there."""
    lib, fn = _entry()
    vec = int(out.shape[1] % 4 == 0 and d.data_ptr() % 16 == 0)
    with torch.cuda.device(out.device):
        err = fn(out.data_ptr(), d.data_ptr(), seg_ptr.data_ptr() + 8 * first,
                 0 if seg_rows is None else seg_rows.data_ptr() + 8 * first, int(base),
                 last - first, out.shape[1], vec, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, lib, "ordered_fold")
    ordered_fold.launches += 1
    ordered_fold.routes["fold"] += 1
    return out


# ------------------------------------------------------------ the chain route

#: the most modes a stream may have on the chain route (the library's
#: ``ordered_chain_max_modes``; the kernel takes the factors' pointers in its
#: parameters)
CHAIN_MAX_MODES = 8


def chain_coords(indices: torch.Tensor, mode: int) -> torch.Tensor:
    """The chain route's coordinates of a stream ``indices (n, nmodes)``: its
    non-target columns in mode order, ``(n, nmodes - 1)`` contiguous int32.
    The run's row stands for the target column, so the kernel never reads
    it. Callers make it once and keep it with the stream."""
    others = [d for d in range(indices.shape[1]) if d != mode]
    return indices[:, others].to(torch.int32).contiguous()


def _check_chain(out, coords, values, factors, mode, seg_ptr, seg_rows):
    nmodes = len(factors)
    if out.ndim != 2 or coords.ndim != 2 or values.ndim != 1:
        raise ValueError(f"out must be (rows, R), coords (n, nmodes - 1) and values (n,); got "
                         f"{tuple(out.shape)}, {tuple(coords.shape)}, {tuple(values.shape)}")
    if nmodes < 2 or coords.shape != (values.shape[0], nmodes - 1):
        raise ValueError(f"coords {tuple(coords.shape)} does not match values "
                         f"{tuple(values.shape)} and {nmodes} factors (the non-target "
                         f"coordinates of at least 2 modes)")
    if not 0 <= mode < nmodes:
        raise ValueError(f"mode {mode} is not one of the {nmodes} modes")
    rank = out.shape[1]
    for d, f in enumerate(factors):
        if f.ndim != 2 or f.shape[1] != rank:
            raise ValueError(f"factor {d} {tuple(f.shape)} does not match out's {rank} "
                             f"rank columns")
    if any(t.dtype != torch.float32 for t in (out, values, *factors)):
        raise TypeError("out, values and the factors must be float32")
    if seg_ptr.ndim != 1 or seg_ptr.shape[0] < 1 or (
            seg_rows is not None and seg_rows.shape != (seg_ptr.shape[0] - 1,)):
        raise ValueError(f"seg_ptr must be (n_seg + 1,) and seg_rows (n_seg,); got "
                         f"{tuple(seg_ptr.shape)} and "
                         f"{None if seg_rows is None else tuple(seg_rows.shape)}")
    tensors = (out, coords, values, *factors, seg_ptr) + (() if seg_rows is None else (seg_rows,))
    if len({t.device for t in tensors}) != 1:
        raise ValueError("out, the stream, the factors and the runs must live on one device")


def ordered_chain_fold_torch(out, coords, values, factors, mode, seg_ptr, seg_rows=None):
    """Plain PyTorch version of :func:`ordered_chain_fold`: the chain
    ``cp_chain_exact`` forms (the gathered rows' Hadamard in mode order, then
    the value) over the runs' stream positions, then one ``index_add_`` into
    the runs' rows, in place; returns ``out``. On the CPU ``index_add_`` adds
    in stream order (bit-equal to the kernel); the chain's ``(n, R)``
    temporary is the whole stream's."""
    factors = tuple(factors)
    _check_chain(out, coords, values, factors, mode, seg_ptr, seg_rows)
    lo, hi = int(seg_ptr[0]), int(seg_ptr[-1])
    rows = seg_rows if seg_rows is not None else torch.arange(
        seg_ptr.shape[0] - 1, device=seg_ptr.device)
    ids = torch.repeat_interleave(rows.long(), seg_ptr.diff())
    others = [f for d, f in enumerate(factors) if d != mode]
    had = None
    for k, f in enumerate(others):
        gathered = f[coords[lo:hi, k].long()]
        had = gathered if had is None else had * gathered
    return out.index_add_(0, ids, values[lo:hi, None] * had)


def ordered_chain_fold(out, coords, values, factors, mode, seg_ptr, seg_rows=None, *,
                       longest_run: int = 0):
    """For each run ``s`` and each nonzero ``p`` of stream positions
    ``[seg_ptr[s], seg_ptr[s+1])`` in order, ``out[row] += values[p] *
    ⊙_{d != mode} factors[d][i_pd]`` (the Hadamard in mode order, then the
    value: ``cp_chain_exact``'s rounded multiplies), one rounded add each,
    starting from ``out[row]``; ``row`` is ``seg_rows[s]`` (``s`` where
    ``seg_rows`` is None) and ``i_pd`` the nonzero's coordinate in mode
    ``d``, column ``k`` of ``coords`` for the ``k``-th non-target mode
    (:func:`chain_coords`). In place; returns ``out``.

    One launch of the chain route on the current stream, without
    synchronizing: ``out (rows, R)`` f32, ``coords (n, nmodes - 1)`` int32,
    ``values (n,)`` f32, 2 to ``CHAIN_MAX_MODES`` factors ``(I_d, R)`` f32
    (the target's is not read), ``seg_ptr (n_seg + 1,)`` and ``seg_rows
    (n_seg,)`` int64, all contiguous CUDA tensors on one device. The kernel
    does not range-check the coordinates: its callers check them once where
    they keep them. Raises on anything else, CPU tensors included: fold
    those with :func:`ordered_chain_fold_torch`. ``longest_run``, the most
    nonzeros a run has where the caller keeps it (0: unknown), lets the
    launch give a long run's CTA more producer warps."""
    factors = tuple(factors)
    _check_chain(out, coords, values, factors, mode, seg_ptr, seg_rows)
    if len(factors) > CHAIN_MAX_MODES:
        raise ValueError(f"the chain route takes up to {CHAIN_MAX_MODES} modes, "
                         f"got {len(factors)}")
    if not out.is_cuda:
        raise ValueError("ordered_chain_fold launches a CUDA kernel and takes CUDA tensors; "
                         "on the CPU use ordered_chain_fold_torch")
    if coords.dtype != torch.int32:
        raise TypeError(f"coords must be int32, got {coords.dtype}")
    if seg_ptr.dtype != torch.int64 or (seg_rows is not None and seg_rows.dtype != torch.int64):
        raise TypeError("seg_ptr and seg_rows must be int64")
    tensors = (out, coords, values, *factors, seg_ptr) + (() if seg_rows is None else (seg_rows,))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("out, the stream, the factors and the runs must be contiguous")
    return _launch_chain(out, coords, values, factors, mode, seg_ptr, seg_rows, longest_run)


def _chain_entry():
    lib = _build.load("ordered_fold")
    fn = lib.ordered_chain_launch
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        lib.ordered_chain_smem_bytes.restype = ctypes.c_longlong
        lib.ordered_chain_smem_bytes.argtypes = [ctypes.c_int] * 2 + [ctypes.c_longlong]
        lib.ordered_chain_max_modes.restype = ctypes.c_int
    return lib, fn


def _chain_smem(nmodes: int, rank: int, longest_run: int = 0) -> int:
    """Dynamic shared memory of a chain-route CTA as the library lays it out
    for a stream of ``nmodes`` modes at ``rank`` whose longest run has
    ``longest_run`` nonzeros (``ordered_chain_smem_bytes``); -1 where it
    cannot launch."""
    lib, _ = _chain_entry()
    return int(lib.ordered_chain_smem_bytes(nmodes, rank, longest_run))


def _launch_chain(out, coords, values, factors, mode, seg_ptr, seg_rows, longest_run: int):
    """One chain-route launch over checked operands (:func:`ordered_chain_fold`)."""
    nmodes, rank = len(factors), out.shape[1]
    if seg_ptr.shape[0] < 2:                 # no run: nothing to launch
        return out
    if _chain_smem(nmodes, rank, longest_run) < 0:
        raise ValueError(f"the chain route's stages do not fit shared memory at rank {rank} "
                         f"with {nmodes} modes")
    others = [f for d, f in enumerate(factors) if d != mode]
    vec = int(rank % 4 == 0 and all(f.data_ptr() % 16 == 0 for f in others))
    ptrs = (ctypes.c_void_p * len(others))(*[f.data_ptr() for f in others])
    lib, fn = _chain_entry()
    with torch.cuda.device(out.device):
        err = fn(out.data_ptr(), coords.data_ptr(), values.data_ptr(),
                 ctypes.cast(ptrs, ctypes.c_void_p), seg_ptr.data_ptr(),
                 0 if seg_rows is None else seg_rows.data_ptr(), seg_ptr.shape[0] - 1,
                 nmodes, rank, int(longest_run), vec, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, lib, "ordered_fold")
    ordered_fold.launches += 1
    ordered_fold.routes["chain"] += 1
    return out


#: kernel launches made by :func:`ordered_fold` and :func:`ordered_chain_fold`
#: (CUDA path only), both routes
ordered_fold.launches = 0
#: the same launches by route: ``"fold"`` (given contributions) and ``"chain"``
ordered_fold.routes = {"fold": 0, "chain": 0}
