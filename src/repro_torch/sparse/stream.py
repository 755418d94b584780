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
the port be compared with the reference kernel on one layout — the exact
eager :func:`stream_mttkrp` that CP-ALS's convergence metric needs, and
:func:`stream_mttkrp_blocked`, the same schedule on the blocked segment-sum
kernel (the ``compiled=False`` sparse path of the ``"hopper"`` backend).
Still to come from the reference module: the schedule IR
(``build_stream_program``), the quantized chain (``psram=True``), the
compiled blocked-fold executor (``_stream_exec_compiled``,
``_blocked_fold_flat``, ``blocked_fold_reference``) and pricing.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.backends.base import resolve_config
from repro_torch.core.mttkrp import cp_chain_exact
from repro_torch.core.psram import PsramConfig
from repro_torch.kernels.ordered_fold import _fold_runs, ordered_fold, ordered_fold_max_rank

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
    the step and its per-nonzero updates are added into the output by
    ``kernels.ordered_fold`` in stream order, each step's fold starting from
    the rows' current values — the fold order of one global
    ``jax.ops.segment_sum`` over the sorted stream, so the result is
    **bit-identical** to the reference's eager executor on the CPU and, on
    the card, to the CPU's and repeatable. ``exec_blocks`` changes the size
    of the temporaries only (a root fiber split across steps is one fold).

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
    runs = None
    if values.is_cuda:          # the runs' checks, made once here and not at each launch
        runs = _fold_segments(csf, step)
        if factors[0].shape[-1] > ordered_fold_max_rank():
            raise ValueError(f"the ordered fold takes up to {ordered_fold_max_rank()} "
                             f"rank columns, got {factors[0].shape[-1]}")
    for c, lo in enumerate(range(0, csf.nnz, step)):
        i_b, v_b = indices[lo:lo + step], values[lo:lo + step]
        d = cp_chain_exact(i_b, v_b, factors, mode)
        if runs is None:                  # the CPU's index_add_, in stream order
            ordered_fold(out, d, i_b[:, mode])
        else:
            seg_ptr, seg_rows, chunk_seg = runs
            _fold_runs(out, d.contiguous(), seg_ptr, seg_rows, chunk_seg[c], chunk_seg[c + 1], lo)
    return out


def _fold_segments(csf: CSF, step: int):
    """The sorted stream's row runs cut at every step boundary, for the
    ordered fold of :func:`stream_mttkrp`: ``(seg_ptr, seg_rows, chunk_seg)``
    with ``seg_ptr (n_seg + 1,)`` contiguous int64 stream offsets and
    ``seg_rows (n_seg,)`` contiguous int64 rows on the CSF's device (the
    output's), and ``chunk_seg`` the host list of each step's first segment
    (and the total last). Host numpy, cached on the CSF per step size, like
    ``_segment_blocks``."""
    key = ("_fold_segments", step)
    cached = csf.__dict__.get(key)
    if cached is not None:
        return cached
    rid = csf.row_of_nonzero().astype(np.int64)
    nnz = len(rid)
    starts = np.flatnonzero(np.r_[True, rid[1:] != rid[:-1]]) if nnz else np.zeros(0, np.int64)
    bounds = np.arange(0, nnz, step, dtype=np.int64)
    cuts = np.union1d(starts, bounds)
    chunk_seg = np.searchsorted(cuts, np.r_[bounds, nnz]).tolist()
    dev = csf.device
    result = (torch.as_tensor(np.r_[cuts, nnz].astype(np.int64), device=dev),
              torch.as_tensor(rid[cuts], device=dev), chunk_seg)
    csf.__dict__[key] = result
    return result


def _segment_blocks(csf: CSF, rows: int):
    """``_block_segments`` with its arrays on the CSF's device, plus the
    padded stream the exact chain runs over and the order the partials are
    folded in: ``(ip, vp, local, n_seg, order, fold_rows, fold_runs)`` with
    ``ip (B, rows, nmodes)`` coordinates (0 in the padding), ``vp (B, rows)``
    values (0.0 in the padding), ``local (B, rows) int32``; ``order (P,)
    int64`` the stable sort of the flattened ``(B*n_seg,)`` segment rows by
    row, the slots of the sacrificial row ``out_rows`` (unused slots,
    padding) dropped; ``fold_rows (P,) int64`` the rows in that order
    (non-decreasing); ``fold_runs (out_rows + 1,) int64`` their
    ``row_runs``. Stable: each row still receives its partials in
    (block, segment) order, the order of the reference's
    ``out.at[seg_rows].add``. Host numpy, cached on the CSF, like the layout
    of the fused kernel: CP-ALS reuses it every sweep."""
    key = ("_stream_segment_blocks", rows)
    cached = csf.__dict__.get(key)
    if cached is not None:
        return cached
    local, seg_rows, n_seg = _block_segments(csf, rows)
    n_blocks = local.shape[0]
    out_rows = csf.shape[csf.mode_order[0]]
    flat = seg_rows.reshape(-1)
    order = np.argsort(flat, kind="stable")
    order = order[flat[order] != out_rows]
    fold_rows = flat[order]
    idx = csf.expanded_indices_np()
    padn = n_blocks * rows - idx.shape[0]
    vals = csf.values.detach().cpu().numpy()
    dev = csf.device
    result = (
        torch.as_tensor(np.pad(idx, ((0, padn), (0, 0))).reshape(n_blocks, rows, -1),
                        device=dev),
        torch.as_tensor(np.pad(vals, (0, padn)).reshape(n_blocks, rows), device=dev),
        torch.as_tensor(local, device=dev),
        n_seg,
        torch.as_tensor(order.astype(np.int64), device=dev),
        torch.as_tensor(fold_rows, device=dev),
        torch.as_tensor(np.searchsorted(fold_rows, np.arange(out_rows + 1)).astype(np.int64),
                        device=dev),
    )
    csf.__dict__[key] = result
    return result


def stream_mttkrp_blocked(
    csf: CSF,
    factors: tuple,
    config: PsramConfig | None = None,
    lowering: str = "auto",
) -> torch.Tensor:
    """The same streaming schedule on the blocked segment-sum kernel:
    (out_rows, R).

    The exact chain ``x_p · ⊙ other-factor rows`` over the padded stream
    (``(B, rows, R)``; padding rows are zero), one blocked segment sum per
    block of ``rows`` nonzeros (kernels/segment_sum.py), then the
    ``(B, n_seg)`` partials are gathered into the cached stable order of
    their rows and folded into the output by ``kernels.ordered_fold``:
    O(segments) adds, no global scatter matrix, each row's partials added in
    (block, segment) order. So the result is the same bits on the CPU and
    on the card, and repeatable there. Combining partials reassociates the
    float adds, so this path is allclose (~1e-5 relative), not bit-equal, to
    :func:`stream_mttkrp` (and to the reference, whose blocked segment sum
    is a matrix product).
    """
    from repro_torch.kernels.ops import blocked_segment_sum_op

    cfg = resolve_config(config)
    mode = csf.mode_order[0]
    ip, vp, local, n_seg, order, fold_rows, fold_runs = _segment_blocks(csf, cfg.rows)
    d = cp_chain_exact(ip, vp, tuple(factors), mode)        # (B, rows, R)
    partials = blocked_segment_sum_op(d, local, n_seg, lowering=lowering)
    rank = d.shape[-1]
    out = torch.zeros((csf.shape[mode], rank), dtype=torch.float32, device=d.device)
    return ordered_fold(out, partials.reshape(-1, rank).index_select(0, order), fold_rows,
                        runs=fold_runs)
