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

* ``"fold"`` — :func:`ordered_fold`: the contributions are given, as rows
  of ``d``, read in place through an optional gather index ``order`` (the
  fold's stream row ``i`` is ``d[order[i]]``). A warp folds eight short
  runs at a time (lane = rank column, 32 rows in flight before their adds,
  whichever runs they belong to); a run of more than
  :data:`FOLD_LONG_RUN` rows has a CTA of its own, which streams it through
  a shared-memory ring ahead of one warp's adds. The blocked path's
  partials fold through it in their cached order, in place.
* ``"chain"`` — :func:`ordered_chain_fold`: the contributions are formed in
  the kernel from the stream's non-target coordinates (:func:`chain_coords`),
  values and factors,
  ``d_p = v_p · ⊙ other-factor rows`` with ``cp_chain_exact``'s rounded
  multiplies, so a whole exact sparse MTTKRP is one launch and no ``(n, R)``
  temporary. One CTA per run: producer warps gather and multiply ahead of
  one warp that owns the chain of adds. Bound by the stream's bytes and the
  factor rows' L2 gathers, and for a long run by its chain of dependent adds
  — see the source note. With ``psram=True`` the producers form the
  quantized chain instead (``core.mttkrp.cp_chain_psram``: 8-bit operands
  and the ADC on every product, each quotient the IEEE one), counted apart
  as ``"chain_psram"``; the consumer's adds do not change. At a rank of
  :data:`TEMPLATE_RANKS` a run of :data:`CHAIN_LONG_RUN` nonzeros or more
  takes a thread-block cluster: its producers on 7 SMs, its adds on an 8th.

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

import numpy as np
import torch

from repro_torch.core.quantization import QMAX

from . import _build


#: rows a run may have and still be folded by one warp of the fold route;
#: a longer run has a CTA of its own, which streams it through a
#: shared-memory ring
FOLD_LONG_RUN = 64


def _check(out, d, ids, order=None):
    if out.ndim != 2 or d.ndim != 2 or ids.ndim != 1:
        raise ValueError(f"out must be (rows, R), d (n, R) and ids (n,); got "
                         f"{tuple(out.shape)}, {tuple(d.shape)}, {tuple(ids.shape)}")
    if order is not None and (order.dtype != torch.int64 or order.ndim != 1):
        raise TypeError(f"order must be (P,) int64, got {tuple(order.shape)} {order.dtype}")
    stream_rows = d.shape[0] if order is None else order.shape[0]
    if d.shape[1] != out.shape[1] or ids.shape[0] != stream_rows:
        raise ValueError(f"d {tuple(d.shape)} does not match out {tuple(out.shape)} "
                         f"and ids {tuple(ids.shape)}")
    if out.dtype != torch.float32 or d.dtype != torch.float32:
        raise TypeError(f"out and d must be float32, got {out.dtype} / {d.dtype}")
    if len({out.device, d.device, ids.device}) != 1:
        raise ValueError("out, d and ids must live on one device")
    if order is None:
        return
    if order.device != d.device:
        raise ValueError(f"order must live on d's device {d.device}, got {order.device}")
    if order.numel():
        low, high = (int(v) for v in torch.aminmax(order))
        if low < 0 or high >= d.shape[0]:
            raise IndexError(f"order spans [{low}, {high}], outside d's {d.shape[0]} rows")


def ordered_fold_torch(out: torch.Tensor, d: torch.Tensor, ids: torch.Tensor,
                       order: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: ``out.index_add_(0, ids, d[order])`` (``d``
    where ``order`` is None), in place. On the CPU ``index_add_`` adds the
    contributions in stream order."""
    _check(out, d, ids, order)
    if order is not None:
        d = d.index_select(0, order)
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
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] \
            + [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
        lib.ordered_fold_max_rank.restype = ctypes.c_int
    return lib, fn


@functools.cache
def ordered_fold_max_rank() -> int:
    """The most rank columns the kernel takes, as the built library states it."""
    lib, _ = _entry()
    return lib.ordered_fold_max_rank()


def ordered_fold(out: torch.Tensor, d: torch.Tensor, ids: torch.Tensor,
                 runs: torch.Tensor | None = None,
                 order: torch.Tensor | None = None) -> torch.Tensor:
    """``out[ids[i]] += d[order[i]]`` (``d[i]`` where ``order`` is None) for
    every ``i``, in stream order, in place; returns ``out``. ``ids`` must be
    sorted non-decreasing (the kernel takes each row's run as one contiguous
    block; it does not check); ``order (P,)`` int64 on ``d``'s device, one
    entry an ``ids`` entry, each a row of ``d`` (checked: an ``IndexError``
    names the range), so ``d`` is read in place instead of gathered first.

    CUDA tensors go through one kernel launch on the current stream; ``runs``
    is :func:`row_runs` of ``ids`` where the caller keeps it (else it is
    formed here). The checks wait for the device: ``order``'s range, and
    the long runs (:func:`find_long_runs`) read from ``runs`` on the host.
    A caller that keeps its runs and its order and made both itself (the
    blocked path) launches through :func:`_fold_runs` with its long runs
    instead. CPU tensors go through :func:`ordered_fold_torch`."""
    _check(out, d, ids, order)
    if not out.is_cuda:
        return ordered_fold_torch(out, d, ids, order)
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    if runs is None:
        runs = row_runs(ids, out.shape[0])
    if (runs.dtype != torch.int64 or not runs.is_contiguous() or runs.device != out.device
            or runs.shape != (out.shape[0] + 1,)):
        raise ValueError(f"runs must be the ({out.shape[0] + 1},) int64 row_runs of ids "
                         f"on {out.device}")
    return _fold_runs(out, d.contiguous(), runs, None, 0, out.shape[0], 0,
                      order=None if order is None else order.contiguous())


def find_long_runs(seg_ptr, long_run: int = FOLD_LONG_RUN) -> np.ndarray:
    """The runs of host offsets ``seg_ptr (n_seg + 1,)`` with more than
    ``long_run`` rows, longest first (so the longest run's CTA starts
    soonest), as int64 run indices: the fold route's ``long_runs``. A caller
    that keeps its runs keeps these with them (``sparse.stream._segment_blocks``)."""
    lengths = np.diff(np.asarray(seg_ptr, dtype=np.int64))
    found = np.flatnonzero(lengths > long_run)
    return found[np.argsort(-lengths[found], kind="stable")]


def _fold_runs(out, d, seg_ptr, seg_rows, first: int, last: int, base: int,
               order=None, long_runs=None, long_run: int = FOLD_LONG_RUN) -> torch.Tensor:
    """One launch over segments ``[first, last)`` of precomputed runs:
    segment ``s`` folds the stream rows ``[seg_ptr[s] - base, seg_ptr[s+1] -
    base)`` into row ``seg_rows[s]`` (row ``s`` where ``seg_rows`` is None),
    stream row ``i`` being ``d[order[i]]`` (``d[i]`` where ``order`` is
    None); a run of more than ``long_run`` rows has a CTA of its own.
    ``long_runs`` lists them (:func:`find_long_runs` of ``seg_ptr[first:last
    + 1]``, on ``out``'s device); where it is None they are found here,
    which waits for the device. For callers that checked their operands or
    made them (:func:`ordered_fold`, the blocked path): contiguous int64
    runs and order on ``out``'s device, every order entry a row of ``d``,
    ``out`` and ``d`` contiguous f32 there."""
    if out.shape[1] > ordered_fold_max_rank():
        raise ValueError(f"the ordered fold takes up to {ordered_fold_max_rank()} "
                         f"rank columns, got {out.shape[1]}")
    if long_runs is None:
        long_runs = torch.as_tensor(find_long_runs(seg_ptr[first:last + 1].cpu(), long_run),
                                    device=out.device)
    lib, fn = _entry()
    vec = int(out.shape[1] % 4 == 0 and d.data_ptr() % 16 == 0)
    with torch.cuda.device(out.device):
        err = fn(out.data_ptr(), d.data_ptr(), 0 if order is None else order.data_ptr(),
                 seg_ptr.data_ptr() + 8 * first,
                 0 if seg_rows is None else seg_rows.data_ptr() + 8 * first, int(base),
                 last - first, long_runs.data_ptr(), long_runs.numel(), out.shape[1], vec,
                 int(long_run), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, lib, "ordered_fold")
    ordered_fold.launches += 1
    ordered_fold.routes["fold"] += 1
    return out


# ------------------------------------------------------------ the chain route

#: the most modes a stream may have on the chain route (the library's
#: ``ordered_chain_max_modes``; the kernel takes the factors' pointers in its
#: parameters)
CHAIN_MAX_MODES = 8

#: nonzeros from which a run of the quantized chain route at a template rank
#: (16, 32, 64, 128) takes a thread-block cluster (the library's
#: ``ordered_psram_long_run``): its producers on several SMs
CHAIN_LONG_RUN = 32768

#: ranks whose quantized chain the route forms a row as ``R / 4`` lanes
#: (``ordered_psram_kernel``); the clusters are theirs
TEMPLATE_RANKS = (16, 32, 64, 128)


def chain_long_runs(seg_ptr) -> np.ndarray:
    """The runs of host offsets ``seg_ptr (n_seg + 1,)`` that the quantized
    chain route gives a cluster: every run of ``CHAIN_LONG_RUN`` nonzeros or
    more, longest first (:func:`find_long_runs` at ``CHAIN_LONG_RUN - 1``).
    The launch's other CTAs take every other run, so the two cover each run
    once. Callers that keep their runs keep these with them
    (``sparse.stream._chain_stream``)."""
    return find_long_runs(seg_ptr, CHAIN_LONG_RUN - 1)


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


def ordered_chain_fold_torch(out, coords, values, factors, mode, seg_ptr, seg_rows=None,
                             psram: bool = False, adc_bits: int = 16):
    """Plain PyTorch version of :func:`ordered_chain_fold`: the chain
    ``cp_chain_exact`` forms (the gathered rows' Hadamard in mode order, then
    the value), or with ``psram`` the quantized chain of ``cp_chain_psram``
    at ``adc_bits``, over the runs' stream positions, then one ``index_add_``
    into the runs' rows, in place; returns ``out``. On the CPU
    ``index_add_`` adds in stream order (bit-equal to the kernel); the
    chain's ``(n, R)`` temporary is the whole stream's."""
    from repro_torch.core.mttkrp import psram_chain

    factors = tuple(factors)
    _check_chain(out, coords, values, factors, mode, seg_ptr, seg_rows)
    lo, hi = int(seg_ptr[0]), int(seg_ptr[-1])
    rows = seg_rows if seg_rows is not None else torch.arange(
        seg_ptr.shape[0] - 1, device=seg_ptr.device)
    ids = torch.repeat_interleave(rows.long(), seg_ptr.diff())
    others = [f for d, f in enumerate(factors) if d != mode]
    gathered = [f[coords[lo:hi, k].long()] for k, f in enumerate(others)]
    if psram:
        return out.index_add_(0, ids, psram_chain(gathered, values[lo:hi], adc_bits))
    had = gathered[0]
    for g in gathered[1:]:
        had = had * g
    return out.index_add_(0, ids, values[lo:hi, None] * had)


def adc_operands(adc_bits: int) -> tuple[float, float, float]:
    """What a quantized chain route's ADC takes from the host: the LSB of
    the products' full scale ``QMAX²`` at ``2**adc_bits`` levels, formed in
    double and rounded once to f32 on the way (``adc_transfer``'s note); the
    largest code, ``levels / 2 - 1``; and the LSB's reciprocal, the IEEE f32
    quotient ``1 / lsb``, through which the kernels divide by the LSB
    (``hopper::psram_div``: reciprocal and two fma corrections, the IEEE
    quotient). Raises outside the kernels' 1..24 bits."""
    if not 1 <= adc_bits <= 24:
        raise ValueError(f"adc_bits must be in 1..24 for the kernel, got {adc_bits}")
    levels = 2 ** adc_bits
    lsb = 2.0 * (float(QMAX) * float(QMAX)) / levels
    return lsb, float(levels // 2 - 1), float(np.float32(1.0) / np.float32(lsb))


def ordered_chain_fold(out, coords, values, factors, mode, seg_ptr, seg_rows=None, *,
                       longest_run: int = 0, long_runs=None, psram: bool = False,
                       adc_bits: int = 16):
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
    launch give a long run's CTA more producer warps. ``psram=True`` adds the
    quantized chain ``cp_chain_psram`` forms at ``adc_bits`` (1..24) in place
    of the exact one, the same bits as :func:`ordered_chain_fold_torch` with
    ``psram=True`` on the CPU; counted under ``routes["chain_psram"]``. At a
    rank of :data:`TEMPLATE_RANKS` its runs of ``CHAIN_LONG_RUN`` nonzeros or
    more take a thread-block cluster each, in the same launch as the other
    runs: ``long_runs`` lists them (:func:`chain_long_runs` of ``seg_ptr``,
    int64 on ``out``'s device), as callers that keep their runs keep it;
    where it is None it is found here, which waits for the device. A launch
    the card refuses raises. ``ordered_fold.last_psram`` says how the last
    quantized launch was laid out."""
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
    adc = adc_operands(adc_bits) if psram else None
    if psram and out.shape[1] in TEMPLATE_RANKS:
        if long_runs is None:
            long_runs = torch.as_tensor(chain_long_runs(seg_ptr.cpu()), device=out.device)
        if (long_runs.dtype != torch.int64 or long_runs.ndim != 1
                or long_runs.device != out.device or not long_runs.is_contiguous()):
            raise ValueError("long_runs must be a contiguous (n_long,) int64 tensor on "
                             f"{out.device}")
    else:
        long_runs = None
    return _launch_chain(out, coords, values, factors, mode, seg_ptr, seg_rows, longest_run, adc,
                         long_runs)


def _chain_entry():
    lib = _build.load("ordered_fold")
    fn = lib.ordered_chain_launch
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
            + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_int] + [ctypes.c_float] * 3 \
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.ordered_chain_smem_bytes.restype = ctypes.c_longlong
        lib.ordered_chain_smem_bytes.argtypes = [ctypes.c_int] * 2 + [ctypes.c_longlong]
        lib.ordered_chain_max_modes.restype = ctypes.c_int
        lib.ordered_psram_smem_bytes.restype = ctypes.c_longlong
        lib.ordered_psram_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.ordered_psram_producers.restype = ctypes.c_int
        lib.ordered_psram_producers.argtypes = [ctypes.c_int] * 3
        lib.ordered_psram_long_run.restype = ctypes.c_longlong
        lib.ordered_psram_cluster.restype = ctypes.c_int
    return lib, fn


def _chain_smem(nmodes: int, rank: int, longest_run: int = 0) -> int:
    """Dynamic shared memory of a chain-route CTA as the library lays it out
    for a stream of ``nmodes`` modes at ``rank`` whose longest run has
    ``longest_run`` nonzeros (``ordered_chain_smem_bytes``); -1 where it
    cannot launch."""
    lib, _ = _chain_entry()
    return int(lib.ordered_chain_smem_bytes(nmodes, rank, longest_run))


def _psram_layout(nmodes: int, rank: int, cluster: bool) -> tuple[int, int]:
    """``(producer warps a CTA, dynamic shared memory)`` of the quantized
    chain route at a template rank as the library lays it out
    (``ordered_psram_producers``, ``ordered_psram_smem_bytes``), where the
    launch gives its long runs clusters or not; -1 bytes where it cannot
    launch."""
    lib, _ = _chain_entry()
    return (int(lib.ordered_psram_producers(nmodes, rank, int(cluster))),
            int(lib.ordered_psram_smem_bytes(nmodes, rank, int(cluster))))


def _launch_chain(out, coords, values, factors, mode, seg_ptr, seg_rows, longest_run: int,
                  adc=None, long_runs=None):
    """One chain-route launch over checked operands (:func:`ordered_chain_fold`);
    ``adc`` the quantized chain's :func:`adc_operands`, None for the exact
    chain; ``long_runs`` the runs the quantized route at a template rank gives
    a cluster (None elsewhere)."""
    nmodes, rank = len(factors), out.shape[1]
    if seg_ptr.shape[0] < 2:                 # no run: nothing to launch
        return out
    n_long = 0 if long_runs is None else long_runs.numel()
    if long_runs is not None:
        producers, smem = _psram_layout(nmodes, rank, n_long > 0)
    else:
        producers, smem = 0, _chain_smem(nmodes, rank, longest_run)
    if smem < 0:
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
                 nmodes, rank, int(longest_run), vec, int(adc is not None),
                 *(adc or (0.0, 0.0, 0.0)), 0 if long_runs is None else long_runs.data_ptr(),
                 n_long, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, lib, "ordered_fold")
    ordered_fold.launches += 1
    ordered_fold.routes["chain" if adc is None else "chain_psram"] += 1
    if long_runs is not None:
        ordered_fold.last_psram = {
            "clusters": n_long, "cluster_ctas": int(lib.ordered_psram_cluster()) if n_long else 1,
            "short_ctas": seg_ptr.shape[0] - 1 - n_long, "producers": producers,
            "smem_bytes": smem}
    return out


def _probe_entry():
    lib = _build.load("ordered_fold")
    fn = lib.psram_division_probe_launch
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 2
        rows = lib.psram_division_rows_launch
        rows.restype = ctypes.c_int
        rows.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] \
            + [ctypes.c_void_p] * 3
    return lib, fn


def _division_probe(kind: str, adc_bits: int = 16) -> tuple[int, int]:
    """The quantized chains' quotients (``hopper::psram_div``) against
    ``__fdiv_rn`` on the card, exhaustively: ``kind="adc"`` every integer
    product in ``[-127², 127²]`` and -0.0 at ``adc_bits`` (the quotient's bits
    and the ADC's value), ``"value"`` every finite f32 value's code at its
    own scale. Returns ``(values that differ, the least such index)``."""
    lib, fn = _probe_entry()
    bad = torch.tensor([0, 2 ** 63 - 1], dtype=torch.int64, device="cuda")
    with torch.cuda.device(bad.device):
        err = fn({"adc": 0, "value": 1}[kind], *adc_operands(adc_bits), bad.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, lib, "ordered_fold")
    count, first = bad.tolist()
    return count, first


def _division_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows ``x (n, R)`` f32 on the card quantized as the chains quantize a
    row (its scale's reciprocal and ``psram_div``) and through ``__fdiv_rn``:
    ``(codes, codes_div)``, both ``(n, R)`` f32."""
    lib, _ = _probe_entry()
    x = x.contiguous()
    codes, codes_div = torch.empty_like(x), torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.psram_division_rows_launch(x.data_ptr(), x.shape[0], x.shape[1],
                                             codes.data_ptr(), codes_div.data_ptr(),
                                             torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, lib, "ordered_fold")
    return codes, codes_div


#: kernel launches made by :func:`ordered_fold` and :func:`ordered_chain_fold`
#: (CUDA path only), both routes
ordered_fold.launches = 0
#: the same launches by route: ``"fold"`` (given contributions), ``"chain"``
#: (the exact chain formed in the kernel) and ``"chain_psram"`` (the quantized one)
ordered_fold.routes = {"fold": 0, "chain": 0, "chain_psram": 0}
#: the layout of the last quantized chain-route launch at a template rank:
#: ``clusters`` (its long runs' clusters), ``cluster_ctas`` (CTAs a cluster,
#: 1 for a plain launch), ``short_ctas``, ``producers`` (warps a CTA) and
#: ``smem_bytes``; None before one
ordered_fold.last_psram = None
