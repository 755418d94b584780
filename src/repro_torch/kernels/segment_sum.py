"""Blocked segment sum — the CSF CP3 stage of the streaming schedule.

Per block ``b`` of ``bn`` chain rows, the partial segment sums

    out[b, s, r] = sum over the rows p with seg_ids[b, p] == s of data[b, p, r]

as a ``(B, S, R)`` f32 stack, with no carry between blocks: the caller
scatters the partials into its output rows (``sparse.stream.
stream_mttkrp_blocked``). ``seg_ids`` are block-local ids in ``[0, S)``;
padding rows point at any id in range with zero data.

The hand-written Hopper kernels live in ``csrc/segment_sum.cu`` (CUDA C++,
``sm_90a``); they replace the TPU kernel ``src/repro/kernels/segment_sum.py:
_kernel`` (launched by ``blocked_segment_sum``). The TPU kernel's one-hot
``(S, bn)`` mask matmul becomes a segmented reduction: one warp per block,
lane = rank column, the rows added in order. Two routes, counted in
``blocked_segment_sum.routes``:

* ``"rows"`` — :func:`blocked_segment_sum`, the TPU kernel's own signature:
  the chain rows ``data (B, bn, R)`` are given, and each block's rows are
  added into a per-warp ``(S, 32)`` shared-memory tile. Bound by bytes.
* ``"chain"`` — :func:`blocked_chain_segment_sum`: the chain rows of a
  sparse stream are formed in the kernel from its non-target coordinates
  (``kernels.ordered_fold.chain_coords``), values and factors, ``d_p = v_p ·
  ⊙ other-factor rows`` with ``cp_chain_exact``'s rounded multiplies, so
  the ``(B, bn, R)`` chain never exists in device memory; a segment's sum
  is stored when its run of (non-decreasing) ids ends. Bound by the factor
  rows it gathers from L2 — see the source note. The ``compiled=False``
  sparse path runs it. With ``psram=True`` the chain rows are the quantized
  chain of ``core.mttkrp.cp_chain_psram`` (8-bit operands and the ADC on
  every product), formed from whole rows because each scale reduces over
  the row (at ``R = 4 .. 128``, ``R / 4`` a power of 2, a row is ``R / 4``
  lanes and each lane forms two rows at once in registers); counted apart
  as ``"chain_psram"``. The ``psram-stream`` backend's compiled path runs it.

Both add every ``(b, s, r)`` from 0.0 in row order, one rounded add a row,
so the chain route gives the bits of the rows route over the padded chain.
:func:`blocked_segment_sum` launches its kernel for CUDA tensors (or
raises) and, for CPU tensors — only because they lie on the CPU — uses
:func:`blocked_segment_sum_torch`, one ``index_add_`` over ``b·S + seg``.
On the CPU ``index_add_`` adds in row order, as the kernels do, so the two
are **bit-equal** there; on the card ``index_add_`` is atomic and
unordered, so the plain version agrees with the kernel within float
reassociation only. :func:`blocked_chain_segment_sum` takes CUDA tensors
only; its plain version :func:`blocked_chain_segment_sum_torch` pads the
stream, forms the chain with ``cp_chain_exact`` and sums it with
:func:`blocked_segment_sum_torch`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ordered_fold import CHAIN_MAX_MODES, adc_operands

#: the most segments per block the kernel's shared-memory tile holds
#: (227 KB of opt-in shared memory / (32 columns x 4 bytes))
MAX_SEGMENTS = 232448 // (32 * 4)


def _check(data, seg_ids, n_seg):
    if data.ndim != 3:
        raise ValueError(f"data must be (B, bn, R), got {tuple(data.shape)}")
    b, bn, r = data.shape
    if tuple(seg_ids.shape) != (b, bn):
        raise ValueError(f"seg_ids must be (B, bn)={b, bn}, got {tuple(seg_ids.shape)}")
    if data.dtype != torch.float32 or seg_ids.dtype != torch.int32:
        raise TypeError(f"data/seg_ids must be float32/int32, got {data.dtype}/{seg_ids.dtype}")
    if data.device != seg_ids.device:
        raise ValueError("data and seg_ids must live on one device")
    if n_seg < 1:
        raise ValueError(f"n_seg must be positive, got {n_seg}")
    return b, bn, r


def blocked_segment_sum_torch(data, seg_ids, n_seg: int) -> torch.Tensor:
    """Plain PyTorch version: one ``index_add_`` of every row into slot
    ``b·S + seg`` of a zeroed ``(B·S, R)`` stack."""
    b, bn, r = _check(data, seg_ids, n_seg)
    slot = (torch.arange(b, device=data.device).view(b, 1) * n_seg + seg_ids).reshape(-1)
    out = torch.zeros((b * n_seg, r), dtype=torch.float32, device=data.device)
    out.index_add_(0, slot, data.reshape(b * bn, r))
    return out.view(b, n_seg, r)


def _entry():
    lib = _build.load("segment_sum")
    fn = lib.segment_sum_launch
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib, fn


def blocked_segment_sum(data, seg_ids, n_seg: int) -> torch.Tensor:
    """Per-block partial segment sums ``(B, n_seg, R)`` f32. CUDA tensors go
    through the kernel on the current stream, without synchronizing; CPU
    tensors through :func:`blocked_segment_sum_torch`."""
    b, bn, r = _check(data, seg_ids, n_seg)
    if not data.is_cuda:
        return blocked_segment_sum_torch(data, seg_ids, n_seg)
    if n_seg > MAX_SEGMENTS:
        raise ValueError(
            f"n_seg={n_seg} exceeds the {MAX_SEGMENTS} segments per block the "
            "kernel's shared-memory tile holds")
    if not data.is_contiguous() or not seg_ids.is_contiguous():
        raise ValueError("data and seg_ids must be contiguous")
    with torch.cuda.device(data.device):
        out = torch.empty((b, n_seg, r), dtype=torch.float32, device=data.device)
        lib, fn = _entry()
        err = fn(data.data_ptr(), seg_ids.data_ptr(), out.data_ptr(), b, bn, r, n_seg,
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, lib, "segment_sum")
    blocked_segment_sum.launches += 1
    blocked_segment_sum.routes["rows"] += 1
    return out


# ------------------------------------------------------------ the chain route


def _check_chain(coords, values, seg_ids, factors, mode):
    nmodes = len(factors)
    if coords.ndim != 2 or values.ndim != 1 or seg_ids.ndim != 2:
        raise ValueError(f"coords must be (nnz, nmodes - 1), values (nnz,) and seg_ids "
                         f"(B, bn); got {tuple(coords.shape)}, {tuple(values.shape)}, "
                         f"{tuple(seg_ids.shape)}")
    if nmodes < 2 or coords.shape != (values.shape[0], nmodes - 1):
        raise ValueError(f"coords {tuple(coords.shape)} does not match values "
                         f"{tuple(values.shape)} and {nmodes} factors (the non-target "
                         f"coordinates of at least 2 modes)")
    if not 0 <= mode < nmodes:
        raise ValueError(f"mode {mode} is not one of the {nmodes} modes")
    b, bn = seg_ids.shape
    if b < 1 or bn < 1 or values.shape[0] > b * bn:
        raise ValueError(f"{values.shape[0]} nonzeros do not fit {b} blocks of {bn}")
    rank = factors[0].shape[-1]
    for d, f in enumerate(factors):
        if f.ndim != 2 or f.shape[1] != rank:
            raise ValueError(f"factor {d} {tuple(f.shape)} does not match factor 0's "
                             f"{rank} rank columns")
    if any(t.dtype != torch.float32 for t in (values, *factors)) \
            or seg_ids.dtype != torch.int32:
        raise TypeError("values and the factors must be float32, seg_ids int32")
    if len({t.device for t in (coords, values, seg_ids, *factors)}) != 1:
        raise ValueError("the stream, its segment ids and the factors must live on one device")
    return b, bn, rank


def padded_chain(coords, values, seg_ids, factors, mode: int, psram: bool = False,
                 adc_bits: int = 16) -> torch.Tensor:
    """The exact chain ``cp_chain_exact`` forms (with ``psram``, the quantized
    chain of ``cp_chain_psram`` at ``adc_bits``) over the stream padded to
    ``seg_ids``' ``(B, bn)`` blocks: ``(B, bn, R)`` f32, the padding
    positions' rows those of value 0.0 at coordinate 0 (zeros). What
    :func:`blocked_segment_sum` takes; the chain route never forms it."""
    from repro_torch.core.mttkrp import cp_chain_exact, cp_chain_psram

    factors = tuple(factors)
    _check_chain(coords, values, seg_ids, factors, mode)
    b, bn = seg_ids.shape
    n, nmodes = values.shape[0], len(factors)
    others = [d for d in range(nmodes) if d != mode]
    idx = torch.zeros((b * bn, nmodes), dtype=coords.dtype, device=coords.device)
    idx[:n, others] = coords                # the target column is never read
    vals = torch.nn.functional.pad(values, (0, b * bn - n))
    if psram:
        return cp_chain_psram(idx.view(b, bn, nmodes), vals.view(b, bn), factors, mode,
                              adc_bits)
    return cp_chain_exact(idx.view(b, bn, nmodes), vals.view(b, bn), factors, mode)


def blocked_chain_segment_sum_torch(coords, values, seg_ids, factors, mode: int,
                                    n_seg: int, psram: bool = False,
                                    adc_bits: int = 16) -> torch.Tensor:
    """Plain PyTorch version of :func:`blocked_chain_segment_sum`: the padded
    chain (:func:`padded_chain`, quantized with ``psram``), then
    :func:`blocked_segment_sum_torch`. On the CPU bit-equal to the kernel;
    its ``(B, bn, R)`` temporary is the whole padded stream's."""
    return blocked_segment_sum_torch(
        padded_chain(coords, values, seg_ids, factors, mode, psram, adc_bits), seg_ids, n_seg)


def _chain_entry():
    lib = _build.load("segment_sum")
    fn = lib.segment_chain_launch
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 7 \
            + [ctypes.c_float] * 3 + [ctypes.c_void_p]
        lib.segment_chain_smem_bytes.restype = ctypes.c_longlong
        lib.segment_chain_smem_bytes.argtypes = [ctypes.c_int] * 3
    return lib, fn


def blocked_chain_segment_sum(coords, values, seg_ids, factors, mode: int,
                              n_seg: int, *, psram: bool = False,
                              adc_bits: int = 16) -> torch.Tensor:
    """Per-block partial segment sums ``(B, n_seg, R)`` f32 of a sparse
    stream's exact chain: block ``b`` sums, for each stream position ``p``
    of ``[b·bn, min((b+1)·bn, nnz))`` in order, ``values[p] · ⊙_{d != mode}
    factors[d][i_pd]`` (the Hadamard in mode order, then the value) into
    slot ``seg_ids[b, p - b·bn]``, each slot from 0.0; slots no position
    maps to are 0.0, ids outside ``[0, n_seg)`` are skipped. ``i_pd`` is
    column ``k`` of ``coords`` for the ``k``-th non-target mode
    (``kernels.ordered_fold.chain_coords``).

    One launch of the chain route on the current stream, without
    synchronizing: ``coords (nnz, nmodes - 1)`` int32, ``values (nnz,)``
    f32, ``seg_ids (B, bn)`` int32 with ``nnz <= B·bn`` (non-decreasing
    within a block is the fast case: a slot's sum is stored once), 2 to
    ``CHAIN_MAX_MODES`` factors ``(I_d, R)`` f32 (the target's is not
    read), all contiguous CUDA tensors on one device. The kernel does not
    range-check the coordinates: its callers check them once where they
    keep the stream (``sparse.stream.stream_mttkrp_blocked``). Raises on
    anything else, CPU tensors included: sum those with
    :func:`blocked_chain_segment_sum_torch`. ``psram=True`` sums the
    quantized chain ``cp_chain_psram`` forms at ``adc_bits`` (1..24) instead,
    the same bits as the plain version with ``psram=True`` on the CPU; its
    warps hold whole rows of the factors, so a rank whose rows do not fit
    shared memory raises; counted under ``routes["chain_psram"]``."""
    factors = tuple(factors)
    b, bn, rank = _check_chain(coords, values, seg_ids, factors, mode)
    if n_seg < 1:
        raise ValueError(f"n_seg must be positive, got {n_seg}")
    if len(factors) > CHAIN_MAX_MODES:
        raise ValueError(f"the chain route takes up to {CHAIN_MAX_MODES} modes, "
                         f"got {len(factors)}")
    if not values.is_cuda:
        raise ValueError("blocked_chain_segment_sum launches a CUDA kernel and takes CUDA "
                         "tensors; on the CPU use blocked_chain_segment_sum_torch")
    if coords.dtype != torch.int32:
        raise TypeError(f"coords must be int32, got {coords.dtype}")
    if not all(t.is_contiguous() for t in (coords, values, seg_ids, *factors)):
        raise ValueError("the stream, its segment ids and the factors must be contiguous")
    adc = adc_operands(adc_bits) if psram else (0.0, 0.0, 0.0)
    lib, fn = _chain_entry()
    if lib.segment_chain_smem_bytes(len(factors), rank, int(psram)) < 0:
        raise ValueError(f"the chain route's slots do not fit shared memory at rank {rank} "
                         f"with {len(factors)} modes")
    others = [f for d, f in enumerate(factors) if d != mode]
    ptrs = (ctypes.c_void_p * len(others))(*[f.data_ptr() for f in others])
    vec = int(rank % 4 == 0 and all(f.data_ptr() % 16 == 0 for f in others))
    with torch.cuda.device(values.device):
        out = torch.empty((b, n_seg, rank), dtype=torch.float32, device=values.device)
        err = fn(coords.data_ptr(), values.data_ptr(), seg_ids.data_ptr(),
                 ctypes.cast(ptrs, ctypes.c_void_p), out.data_ptr(), values.shape[0], b, bn,
                 len(factors), rank, n_seg, vec, int(psram), *adc,
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, lib, "segment_sum")
    blocked_segment_sum.launches += 1
    blocked_segment_sum.routes["chain_psram" if psram else "chain"] += 1
    return out


#: kernel launches made by :func:`blocked_segment_sum` and
#: :func:`blocked_chain_segment_sum` (CUDA path only), both routes
blocked_segment_sum.launches = 0
#: the same launches by route: ``"rows"`` (given chain rows), ``"chain"`` (the
#: exact chain formed in the kernel) and ``"chain_psram"`` (the quantized one)
blocked_segment_sum.routes = {"rows": 0, "chain": 0, "chain_psram": 0}
