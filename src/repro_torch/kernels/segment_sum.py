"""Blocked segment sum — the CSF CP3 stage of the streaming schedule.

Per block ``b`` of ``bn`` chain rows, the partial segment sums

    out[b, s, r] = sum over the rows p with seg_ids[b, p] == s of data[b, p, r]

as a ``(B, S, R)`` f32 stack, with no carry between blocks: the caller
scatters the partials into its output rows (``sparse.stream.
stream_mttkrp_blocked``). ``seg_ids`` are block-local ids in ``[0, S)``;
padding rows point at any id in range with zero data.

The hand-written Hopper kernel lives in ``csrc/segment_sum.cu`` (CUDA C++,
``sm_90a``); it replaces the TPU kernel ``src/repro/kernels/segment_sum.py:
_kernel`` (launched by ``blocked_segment_sum``). The TPU kernel's one-hot
``(S, bn)`` mask matmul becomes a segmented reduction: one warp per block,
lane = rank column, the rows added in order into a per-warp ``(S, 32)``
shared-memory tile. Bound by bytes on the card. Design notes are in the
``.cu`` file.

:func:`blocked_segment_sum` is the wrapper: for CUDA tensors it launches the
kernel (or raises); for CPU tensors — only because they lie on the CPU — it
uses :func:`blocked_segment_sum_torch`, one ``index_add_`` over
``b·S + seg``. On the CPU ``index_add_`` adds in row order, as the kernel
does, so the two are **bit-equal** there; on the card ``index_add_`` is
atomic and unordered, so the plain version agrees with the kernel within
float reassociation only.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

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
    return out


#: kernel launches made by :func:`blocked_segment_sum` (CUDA path only)
blocked_segment_sum.launches = 0
