"""Streaming sparse MTTKRP: the block layout of the sorted nonzero stream
and its exact eager executor.

The paper's CP1→CP2→CP3 chain (§IV, Figs. 3-4) for a *sparse* tensor, with
no scatter matrix anywhere:

1. Sort nonzeros by the output mode (a :class:`~repro_torch.sparse.formats.CSF`
   with the target mode at the root) so every output row is a contiguous
   *segment* of the nonzero stream.
2. Cut the stream into blocks of at most ``cfg.rows`` nonzeros — one array
   tile's worth of word-lines each — and group ``exec_blocks`` blocks into
   an execution chunk.
3. Per block, one gather per output-row segment; segments that span a block
   boundary carry their partial sum into the next block's accumulation.

Ported here: the host-side blocking (``_block_segments``,
``_compiled_layout``, :func:`stream_layout`) — numpy, cached on the CSF,
equal array-for-array to the reference's, which is what lets a kernel of
the port be compared with the reference kernel on one layout — and the
exact eager :func:`stream_mttkrp` that CP-ALS's convergence metric needs.
Still to come from the reference module: the schedule IR
(``build_stream_program``), the quantized chain (``psram=True``), the
compiled/blocked executors and pricing.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.backends.base import resolve_config
from repro_torch.core.mttkrp import cp_chain_exact
from repro_torch.core.psram import PsramConfig

from .formats import CSF

_DEFAULT_EXEC_NNZ = 65536  # nonzeros per executor step: bounds the chain's
                           # temporaries without fragmenting the launches


def _exec_blocks(rows: int, n_blocks: int, exec_blocks: int | None) -> int:
    if exec_blocks is None:
        exec_blocks = max(1, _DEFAULT_EXEC_NNZ // rows)
    return max(1, min(exec_blocks, n_blocks))


def _block_segments(csf: CSF, rows: int):
    """Block-local segment structure of the sorted stream — host-side
    preprocessing shared by every lowering of the streaming schedule;
    cached on the CSF (the tree is immutable, CP-ALS reuses it every sweep).

    Returns ``(local, seg_rows, n_seg)``: ``local[b, p]`` is the block-local
    segment id of nonzero ``p`` of block ``b``; ``seg_rows[b, s]`` the
    output row of segment ``(b, s)`` (the sacrificial row ``out_rows`` for
    unused slots); ``n_seg`` the max segments per block.
    """
    key = ("_block_segments", rows)
    cached = csf.__dict__.get(key)
    if cached is not None:
        return cached
    out_rows = csf.shape[csf.mode_order[0]]
    rid = csf.row_of_nonzero().astype(np.int64)
    nnz = len(rid)
    n_blocks = max(1, -(-nnz // rows))
    pad = n_blocks * rows - nnz
    ridp = np.pad(rid, (0, pad), constant_values=-1).reshape(n_blocks, rows)
    new = np.ones((n_blocks, rows), dtype=bool)
    new[:, 1:] = ridp[:, 1:] != ridp[:, :-1]
    local = np.cumsum(new, axis=1) - 1                     # (B, rows)
    n_seg = int(local.max()) + 1
    seg_rows = np.full((n_blocks, n_seg), out_rows, dtype=np.int64)
    b_ix, p_ix = np.nonzero(new)
    seg_rows[b_ix, local[b_ix, p_ix]] = ridp[b_ix, p_ix]
    seg_rows[seg_rows < 0] = out_rows                      # padding rows
    result = (local.astype(np.int32), seg_rows, n_seg)
    csf.__dict__[key] = result
    return result


def _compiled_layout(csf: CSF, rows: int, exec_blocks: int):
    """Padded block stacks on the CSF's device — the store-tile contents
    (indices, values) and gather structure (local segment ids, segment→row
    map) grouped into chunks of ``exec_blocks`` blocks. Built in numpy and
    uploaded once. Cached on the CSF like ``expanded_indices``: per-tensor,
    factor-independent preprocessing, paid once and reused every ALS sweep.
    One entry per ``rows`` value — a new ``exec_blocks`` replaces the cached
    stack instead of accumulating O(nnz) device copies per value.
    """
    key = ("_stream_compiled_layout", rows)
    cached = csf.__dict__.get(key)
    if cached is not None and cached[0] == exec_blocks:
        return cached[1]
    out_rows = csf.shape[csf.mode_order[0]]
    idx = csf.expanded_indices_np()
    vals = csf.values.detach().cpu().numpy()
    local, seg_rows, n_seg = _block_segments(csf, rows)
    n_blocks = local.shape[0]
    nnz, nmodes = idx.shape
    padn = n_blocks * rows - nnz
    nb = -(-n_blocks // exec_blocks)
    padb = nb * exec_blocks - n_blocks
    ip = np.pad(idx, ((0, padn + padb * rows), (0, 0)))
    vp = np.pad(vals, (0, padn + padb * rows))
    lp = np.pad(local, ((0, padb), (0, 0)))
    sp = np.pad(seg_rows, ((0, padb), (0, 0)), constant_values=out_rows)
    dev = csf.device
    layout = (
        torch.as_tensor(ip.reshape(nb, exec_blocks, rows, nmodes), device=dev),
        torch.as_tensor(vp.reshape(nb, exec_blocks, rows), device=dev),
        torch.as_tensor(lp.reshape(nb, exec_blocks, rows), device=dev),
        torch.as_tensor(
            sp.reshape(nb, exec_blocks * n_seg).astype(np.int32), device=dev),
        n_seg,
    )
    csf.__dict__[key] = (exec_blocks, layout)
    return layout


def stream_layout(csf: CSF, rows: int, exec_blocks: int):
    """The padded block stacks ``(ip, vp, lp, sp, n_seg)`` of the streaming
    schedule, shared with the fused kernel family
    (kernels/stream_mttkrp.py), so every lowering drains ONE blocking
    (``_block_segments``) with one cached preprocessing per CSF.

    ``ip (nb, E, rows, nmodes) int32`` coordinates, ``vp (nb, E, rows) f32``
    values (0.0 padding), ``lp (nb, E, rows) int32`` block-local segment
    ids, ``sp (nb, E*n_seg) int32`` segment→output-row map (``out_rows`` for
    unused slots), ``n_seg`` the widest block's segment count.
    """
    return _compiled_layout(csf, rows, exec_blocks)


def stream_mttkrp(
    csf: CSF,
    factors: tuple,
    config: PsramConfig | None = None,
    psram: bool = False,
    adc_bits: int = 16,
    compiled: bool = False,
    exec_blocks: int | None = None,
) -> torch.Tensor:
    """Execute the streaming schedule numerically with the exact chain:
    (out_rows, R).

    ``csf``'s root mode is the target mode. The stream is walked in steps of
    ``exec_blocks`` blocks (default ~64Ki nonzeros): the chain runs inside
    the step and its per-nonzero updates are added into the output with
    ``index_add_`` — stream order on the CPU, atomics on a CUDA device (see
    ``core.mttkrp.mttkrp_sparse`` on what that means for bit-identity).
    ``exec_blocks`` changes the size of the temporaries only.

    ``psram=True`` (the quantized chain) and ``compiled=True`` (the blocked
    fold) belong to the ``psram-stream`` slice of the port and raise here.
    """
    if psram or compiled:
        raise NotImplementedError(
            "stream_mttkrp(psram=True / compiled=True) is not ported yet: "
            "the quantized chain and the blocked fold come with the "
            "'psram-stream' backend (ROADMAP Queue A item 1)"
        )
    cfg = resolve_config(config)
    mode = csf.mode_order[0]
    out_rows = csf.shape[mode]
    rows = cfg.rows
    n_blocks = max(1, -(-max(1, csf.nnz) // rows))
    step = rows * _exec_blocks(rows, n_blocks, exec_blocks)
    indices, values = csf.expanded_indices(), csf.values
    factors = tuple(factors)
    out = torch.zeros((out_rows, factors[0].shape[-1]), dtype=torch.float32,
                      device=values.device)
    for lo in range(0, csf.nnz, step):
        i_b, v_b = indices[lo:lo + step], values[lo:lo + step]
        out.index_add_(0, i_b[:, mode].long(),
                       cp_chain_exact(i_b, v_b, factors, mode))
    return out
