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

:func:`build_stream_program` emits that schedule as ``StoreTile`` /
``GatherDrive`` ops of the ``core.schedule`` IR, so ``count_cycles`` /
``program_energy`` price exactly what runs (equal to the reference's), and
:func:`stream_mttkrp_priced` returns a run's result beside its program.

Ported here: the host-side blocking (``_block_segments``,
``_compiled_layout``, :func:`stream_layout`) — numpy, cached on the CSF,
equal array-for-array to the reference's, which is what lets a kernel of
the port be compared with the reference kernel on one layout — and both
executors of :func:`stream_mttkrp`, with the exact chain or the quantized
one (``psram=True``: 8-bit operands and the ADC on every product, the
``"psram-stream"`` backend): the **eager** per-nonzero fold, and the
**compiled** blocked-segment fold (``compiled=True``), which is
:func:`stream_mttkrp_blocked` (the ``compiled=False`` sparse path of the
``"hopper"`` backend runs it with the exact chain). Where the chain ``d_p``
is formed: on the card inside the kernels, never as a tensor (the eager
executor: the ordered fold's chain route; the compiled one: the blocked
segment sum's chain route, its partials then read in place by the ordered
fold's fold route); on the CPU by ``cp_chain_exact`` / ``cp_chain_psram``
(eager: in steps of ~64Ki nonzeros; compiled: over the padded stream, in
the plain version). Beside them the flat oracle of the compiled fold
(:func:`blocked_fold_reference`, one gather-mask contraction over every
block, plain PyTorch), the COO front doors :func:`stream_mttkrp_coo` and
:func:`blocked_fold_mttkrp_coo`, and the schedule and its price
(:func:`rank_tile_widths`, :func:`build_stream_program`,
:class:`StreamedMTTKRP`, :func:`stream_mttkrp_priced`). :func:`stream_mttkrp`
records the reference's ``obs`` span ``stream/mttkrp/execute`` and counters
``stream/nonzeros`` / ``stream/blocks``. The whole reference module is
ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import ieee_f32
from repro_torch.backends.base import resolve_config
from repro_torch.core.mttkrp import cp_chain_exact, cp_chain_psram
from repro_torch.core.psram import PsramConfig
from repro_torch.core.schedule import GatherDrive, StoreTile, TileProgram, stream_block_layout
from repro_torch.kernels.ordered_fold import (_fold_runs, chain_coords, chain_long_runs,
                                              find_long_runs, ordered_chain_fold, ordered_fold,
                                              ordered_fold_torch)

from .formats import COO, CSF, csf_for_mode

def rank_tile_widths(rank: int, word_cols: int) -> tuple[int, ...]:
    """Column widths of the rank-tiles one chain row splits into."""
    if rank < 1:
        raise ValueError("rank must be positive")
    full, rem = divmod(rank, word_cols)
    return (word_cols,) * full + ((rem,) if rem else ())


def build_stream_program(
    fiber_lengths: np.ndarray,
    rank: int,
    config: PsramConfig | None = None,
) -> TileProgram:
    """The streaming schedule for a fiber-length distribution, as an IR
    program (accounting-grade: geometry lives in the ops, ``shape`` stays
    None — the numeric executor is :func:`stream_mttkrp`).

    ``fiber_lengths`` is nonzeros-per-nonempty-output-row in row order
    (``CSF.fiber_lengths()`` / ``SortedCOO.fiber_lengths()``), which is all
    the schedule depends on — paper-scale workloads can be priced from the
    distribution alone without materializing coordinates.
    """
    cfg = resolve_config(config)
    widths = rank_tile_widths(rank, cfg.word_cols)
    nnz_b, seg_b = stream_block_layout(fiber_lengths, cfg.rows)
    ops: list = []
    for bn, bs in zip(nnz_b.tolist(), seg_b.tolist()):
        for w in widths:
            live = bn * w
            ops.append(StoreTile(rows_written=bn, live_words=live))
            ops.append(GatherDrive(
                cycles=-(-bs // cfg.wavelengths),
                segments=bs,
                live_words=live,
                active_words=live,
            ))
    return TileProgram(config=cfg, ops=tuple(ops))


_DEFAULT_EXEC_NNZ = 65536  # nonzeros per executor step on the CPU: bounds the
                           # chain's (step, R) temporaries


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
    """Execute the streaming schedule numerically: (out_rows, R).

    ``csf``'s root mode is the target mode. ``psram`` picks the chain: the
    exact ``d_p = x_p · ⊙ other-factor rows``, or the quantized chain of
    ``cp_chain_psram`` at ``adc_bits`` (every CP1/CP2 product through 8-bit
    operands and the ADC). Either way CP3 is streamed electrical
    accumulation — no scatter matrix.

    The default **eager** executor adds each nonzero's chain into its output
    row in stream order, one rounded add each — the fold order of one global
    ``jax.ops.segment_sum`` over the sorted stream, so the result is
    **bit-identical** to the reference's eager executor run op by op on the
    CPU (with ``psram=True`` its jitted form lands within one ADC code: XLA
    rewrites ``amax / 127`` into a reciprocal multiply) and, on the card, to
    the CPU's and repeatable; ``psram=True`` is bit-for-bit
    ``core.mttkrp.mttkrp_sparse_psram`` on the sorted stream. On the card
    the whole stream is one launch of ``kernels.ordered_fold``'s chain
    route, which forms each ``d_p`` in the kernel (one CTA per root fiber).
    On the CPU the stream is walked in steps of ``exec_blocks`` blocks
    (default ~64Ki nonzeros): the chain runs over the step and
    ``index_add_`` adds it in stream order, each step starting from the
    rows' current values. ``exec_blocks`` shapes the CPU's temporaries only
    (a root fiber split across steps is one fold); the card takes no steps.

    ``compiled=True`` opts into the **blocked-segment fold**: the partial
    sums of each output-row segment of each block of ``config.rows``
    nonzeros, folded into the output in (block, segment) order —
    :func:`stream_mttkrp_blocked` with the same chain, two launches on the
    card. It reassociates the eager fold's adds (~1e-5 relative, the
    quantization unchanged) and is within 1e-6 relative of its flat oracle
    :func:`blocked_fold_reference`; it takes no ``exec_blocks`` (the
    reference's scan chunks change no bit of its result).

    The call records the span ``stream/mttkrp/execute`` (nnz, mode,
    compiled, psram, exec_blocks — the steps the reference's executor takes,
    whatever this device takes) and the counters ``stream/nonzeros`` and
    ``stream/blocks`` while tracing is enabled (``repro_torch.obs``).
    """
    cfg = resolve_config(config)
    factors = tuple(factors)
    mode = csf.mode_order[0]
    nnz = int(csf.nnz)
    rows = cfg.rows
    n_blocks = max(1, -(-max(1, nnz) // rows))
    eb = _exec_blocks(rows, n_blocks, exec_blocks)
    with obs.span("stream/mttkrp/execute", nnz=nnz, mode=int(mode),
                  compiled=compiled, psram=psram, exec_blocks=eb):
        if obs.enabled():
            obs.counter("stream/nonzeros", nnz)
            obs.counter("stream/blocks", n_blocks)
        if compiled:
            return stream_mttkrp_blocked(csf, factors, cfg, psram=psram, adc_bits=adc_bits)
        return _stream_eager(csf, factors, mode, rows * eb, psram, adc_bits)


def _stream_eager(csf: CSF, factors: tuple, mode: int, step: int, psram: bool,
                  adc_bits: int, values: torch.Tensor | None = None) -> torch.Tensor:
    """The eager executor of :func:`stream_mttkrp`: one chain-route launch
    on the card, steps of ``step`` nonzeros on the CPU. ``values`` stands in
    for the CSF's own (the mesh executor's shard faults)."""
    indices = csf.expanded_indices()
    values = csf.values if values is None else values
    out = torch.zeros((csf.shape[mode], factors[0].shape[-1]), dtype=torch.float32,
                      device=values.device)
    if values.is_cuda:            # one launch: a CTA per root fiber, d formed in the kernel
        coords, seg_ptr, seg_rows, longest, ranges, long_runs = _chain_stream(csf)
        _check_ranges(ranges, factors)
        return ordered_chain_fold(out, coords, values, tuple(f.contiguous() for f in factors),
                                  mode, seg_ptr, seg_rows, longest_run=longest,
                                  long_runs=long_runs, psram=psram, adc_bits=adc_bits)
    for lo in range(0, csf.nnz, step):    # the CPU's index_add_, in stream order
        i_b, v_b = indices[lo:lo + step], values[lo:lo + step]
        d = (cp_chain_psram(i_b, v_b, factors, mode, adc_bits) if psram
             else cp_chain_exact(i_b, v_b, factors, mode))
        ordered_fold(out, d, i_b[:, mode])
    return out


def _chain_stream(csf: CSF):
    """What the chain route reads of the sorted stream, cached on the CSF
    (CP-ALS reuses it every sweep): ``(coords, seg_ptr, seg_rows, longest,
    ranges, long_runs)`` — the non-target coordinates in the route's layout
    (``kernels.ordered_fold.chain_coords``), the root fibers as its runs
    (``seg_ptr (n_fibers + 1,)`` int64 stream offsets, ``seg_rows
    (n_fibers,)`` int64 rows), all on the CSF's device; the most nonzeros a
    fiber has; each non-target mode's coordinate range ``{mode: (low,
    high)}`` from the tree's fiber ids, for the caller to hold against its
    factors; and the fibers the quantized route gives a cluster
    (``kernels.ordered_fold.chain_long_runs`` of the host offsets, int64 on
    the CSF's device), so its launch never waits to find them."""
    cached = csf.__dict__.get("_chain_stream")
    if cached is not None:
        return cached
    mode = csf.mode_order[0]
    lengths = csf.fiber_lengths()
    dev = csf.device
    ranges = {m: (int(f.min()), int(f.max()))
              for m, f in zip(csf.mode_order[1:], csf.fids[1:]) if len(f)}
    seg_ptr = np.r_[0, np.cumsum(lengths)].astype(np.int64)
    result = (chain_coords(csf.expanded_indices(), mode),
              torch.as_tensor(seg_ptr, device=dev),
              torch.as_tensor(np.asarray(csf.fids[0], dtype=np.int64), device=dev),
              int(lengths.max(initial=0)), ranges,
              torch.as_tensor(chain_long_runs(seg_ptr), device=dev))
    csf.__dict__["_chain_stream"] = result
    return result


def _check_ranges(ranges: dict, factors: tuple) -> None:
    """Raise ``IndexError`` where a mode's coordinate range (``_chain_stream``'s
    ``{mode: (low, high)}``) reaches outside its factor's rows: the kernels
    that gather factor rows read what they are given."""
    for d, (low, high) in ranges.items():
        if low < 0 or high >= factors[d].shape[0]:
            raise IndexError(f"mode {d}'s coordinates span [{low}, {high}], outside "
                             f"factor {d}'s {factors[d].shape[0]} rows")


def _segment_blocks(csf: CSF, rows: int):
    """``_block_segments`` with its arrays on the CSF's device, plus the order
    the partials are folded in: ``(local, n_seg, order, fold_rows,
    fold_runs, long_runs)`` with ``local (B, rows) int32`` the block-local
    segment ids (the padding of the last block included); ``order (P,)
    int64`` the stable sort of the flattened ``(B*n_seg,)`` segment rows by
    row, the slots of the sacrificial row ``out_rows`` (unused slots,
    padding) dropped, so every entry is a partial's row; ``fold_rows (P,)
    int64`` the rows in that order (non-decreasing); ``fold_runs (out_rows
    + 1,) int64`` their ``row_runs``; ``long_runs`` the rows whose runs the
    fold route gives a CTA of their own (``find_long_runs``). Stable: each row still receives its partials in (block,
    segment) order, the order of the reference's ``out.at[seg_rows].add``.
    Host numpy, cached on the CSF, like the layout of the fused kernel:
    CP-ALS reuses it every sweep. The stream itself is not padded here:
    the blocked segment sum reads ``_chain_stream``'s coordinates and the
    CSF's values."""
    key = ("_stream_segment_blocks", rows)
    cached = csf.__dict__.get(key)
    if cached is not None:
        return cached
    local, seg_rows, n_seg = _block_segments(csf, rows)
    out_rows = csf.shape[csf.mode_order[0]]
    flat = seg_rows.reshape(-1)
    order = np.argsort(flat, kind="stable")
    order = order[flat[order] != out_rows]
    fold_rows = flat[order]
    fold_runs = np.searchsorted(fold_rows, np.arange(out_rows + 1)).astype(np.int64)
    dev = csf.device
    result = (
        torch.as_tensor(local, device=dev),
        n_seg,
        torch.as_tensor(order.astype(np.int64), device=dev),
        torch.as_tensor(fold_rows, device=dev),
        torch.as_tensor(fold_runs, device=dev),
        torch.as_tensor(find_long_runs(fold_runs), device=dev),
    )
    csf.__dict__[key] = result
    return result


def stream_mttkrp_blocked(
    csf: CSF,
    factors: tuple,
    config: PsramConfig | None = None,
    lowering: str = "auto",
    psram: bool = False,
    adc_bits: int = 16,
    values: torch.Tensor | None = None,
) -> torch.Tensor:
    """The same streaming schedule on the blocked segment sum: (out_rows, R).

    Per block of ``rows`` nonzeros of the sorted stream, the partial sums of
    each output-row segment of the exact chain ``x_p · ⊙ other-factor
    rows`` — with ``psram``, of the quantized chain of ``cp_chain_psram`` at
    ``adc_bits`` (the ``"psram-stream"`` backend's compiled path) —
    (``kernels.ops.blocked_chain_segment_sum_op``); then the
    ``(B, n_seg)`` partials are folded into the output by
    ``kernels.ordered_fold``, read in place in the cached stable order of
    their rows (its ``order``): O(segments) adds, no global scatter matrix
    and no gathered copy, each row's partials added in (block, segment)
    order. On the card the chain is formed inside the
    segment-sum kernel (its chain route, one launch a call): no
    ``(B, rows, R)`` chain exists. On the CPU the plain version forms the
    chain over the padded stream and sums it with ``index_add_``. Both add
    each partial in row order from 0.0, so the result is the same bits on
    the CPU and on the card, and repeatable there. Combining partials
    reassociates the float adds, so this path is allclose (~1e-5 relative),
    not bit-equal, to :func:`stream_mttkrp` (and to the reference, whose
    blocked segment sum is a matrix product). A coordinate outside its
    factor raises ``IndexError`` before anything runs. ``values`` (nnz,)
    stands in for the CSF's own (the mesh executor's shard faults).
    """
    from repro_torch.kernels.ops import blocked_chain_segment_sum_op

    cfg = resolve_config(config)
    mode = csf.mode_order[0]
    factors = tuple(f.contiguous() for f in factors)
    local, n_seg, order, fold_rows, fold_runs, long_runs = _segment_blocks(csf, cfg.rows)
    coords, *_, ranges, _ = _chain_stream(csf)
    _check_ranges(ranges, factors)
    values = csf.values if values is None else values
    partials = blocked_chain_segment_sum_op(coords, values, local, factors, mode, n_seg,
                                            lowering=lowering, psram=psram, adc_bits=adc_bits)
    rank = partials.shape[-1]
    out = torch.zeros((csf.shape[mode], rank), dtype=torch.float32, device=partials.device)
    d = partials.reshape(-1, rank).contiguous()
    if not out.is_cuda:
        return ordered_fold_torch(out, d, fold_rows, order)
    # the order, the runs and the long runs are this CSF's own, made on the
    # host once: nothing to check or wait for
    return _fold_runs(out, d, fold_runs, None, 0, out.shape[0], 0, order=order,
                      long_runs=long_runs)


def _mask_partials(d: torch.Tensor, l_b: torch.Tensor, n_seg: int) -> torch.Tensor:
    """All of a block stack's segment sums in one contraction: one-hot gather
    masks (the per-channel binary word-line drives of §IV) against the
    stored chain rows — ``(E, S, rows) @ (E, rows, R) -> (E, S, R)``. The
    plain twin of the reference's TPU blocked segment sum's body (the
    port's kernel sums the rows in order instead)."""
    sids = torch.arange(n_seg, device=l_b.device).view(1, n_seg, 1)
    mask = (sids == l_b[:, None, :].long()).to(torch.float32)
    return torch.bmm(mask, d)


@ieee_f32()
def _blocked_fold_flat(ip, vp, lp, sp, factors: tuple, mode: int, out_rows: int, n_seg: int,
                       psram: bool, adc_bits: int) -> torch.Tensor:
    """The flat blocked-segment fold over padded block stacks ``ip (B, rows,
    nmodes)``, ``vp (B, rows)``, ``lp (B, rows)``, ``sp (B, n_seg)``: the
    chain of every block at once, one gather-mask contraction, one scatter
    of the partials into the output rows in block order (``out_rows`` is
    the sacrificial row of unused slots and padding). A different lowering
    of the blocked fold than the compiled executor's (no kernel, no ordered
    fold; its one-hot is O(B·n_seg·rows)): the oracle it is held to. On the
    CPU ``index_add_`` adds in order; on the card it is atomic."""
    d = (cp_chain_psram(ip, vp, factors, mode, adc_bits) if psram
         else cp_chain_exact(ip, vp, factors, mode))          # (B, rows, R)
    parts = _mask_partials(d, lp, n_seg)                       # (B, S, R)
    rank = factors[0].shape[-1]
    out = torch.zeros((out_rows + 1, rank), dtype=torch.float32, device=d.device)
    out.index_add_(0, sp.reshape(-1).long(), parts.reshape(-1, rank))
    return out[:out_rows]


def blocked_fold_reference(
    csf: CSF,
    factors: tuple,
    config: PsramConfig | None = None,
    psram: bool = False,
    adc_bits: int = 16,
) -> torch.Tensor:
    """The flat blocked-segment fold over a CSF — the parity oracle of
    ``stream_mttkrp(compiled=True)`` (see :func:`_blocked_fold_flat`), on
    the CSF's device."""
    cfg = resolve_config(config)
    mode = csf.mode_order[0]
    local, seg_rows, n_seg = _block_segments(csf, cfg.rows)
    n_blocks = local.shape[0]
    idx = csf.expanded_indices_np()
    padn = n_blocks * cfg.rows - idx.shape[0]
    dev = csf.device
    ip = torch.as_tensor(np.pad(idx, ((0, padn), (0, 0)))
                         .reshape(n_blocks, cfg.rows, idx.shape[1]), device=dev)
    vp = torch.nn.functional.pad(csf.values, (0, padn)).view(n_blocks, cfg.rows)
    return _blocked_fold_flat(ip, vp, torch.as_tensor(local, device=dev),
                              torch.as_tensor(seg_rows, device=dev), tuple(factors), mode,
                              csf.shape[mode], n_seg, psram, adc_bits)


def _coo_csf(indices, values, factors: tuple, mode: int, out_rows: int) -> CSF:
    """The mode-rooted CSF of a COO triple; the factors carry the other
    modes' dims, the target mode takes ``out_rows``. Host-side sort."""
    shape = [int(f.shape[0]) for f in factors]
    shape[mode] = out_rows
    return csf_for_mode(COO(indices=indices, values=values, shape=tuple(shape)), mode)


def blocked_fold_mttkrp_coo(
    indices: torch.Tensor,
    values: torch.Tensor,
    factors: tuple,
    mode: int,
    out_rows: int,
    config: PsramConfig | None = None,
    psram: bool = False,
    adc_bits: int = 16,
) -> torch.Tensor:
    """COO front door of the flat blocked fold (sorts into a mode-rooted CSF
    first) — the delegation target of ``core.mttkrp.mttkrp_sparse_blocked``."""
    factors = tuple(factors)
    return blocked_fold_reference(_coo_csf(indices, values, factors, mode, out_rows), factors,
                                  config, psram=psram, adc_bits=adc_bits)


@dataclasses.dataclass(frozen=True)
class StreamedMTTKRP:
    """Result + priced schedule of one streamed sparse MTTKRP."""

    result: torch.Tensor
    program: TileProgram


def stream_mttkrp_priced(
    csf: CSF,
    factors: tuple,
    config: PsramConfig | None = None,
    psram: bool = False,
    adc_bits: int = 16,
) -> StreamedMTTKRP:
    """Run :func:`stream_mttkrp` (the eager executor: on the card one launch
    of the ordered fold's chain route) and return the executed schedule
    alongside the result, so ``count_cycles``/``program_energy`` price
    exactly it."""
    cfg = resolve_config(config)
    rank = int(factors[0].shape[-1])
    return StreamedMTTKRP(
        result=stream_mttkrp(csf, factors, cfg, psram=psram, adc_bits=adc_bits),
        program=build_stream_program(csf.fiber_lengths(), rank, cfg),
    )


def stream_mttkrp_coo(
    indices: torch.Tensor,
    values: torch.Tensor,
    factors: tuple,
    mode: int,
    out_rows: int,
    config: PsramConfig | None = None,
    psram: bool = False,
    adc_bits: int = 16,
) -> torch.Tensor:
    """COO-triple front door of the eager :func:`stream_mttkrp` (sorts into a
    mode-rooted CSF first) — the delegation target of
    ``core.mttkrp.mttkrp_sparse_psram_scheduled``. The sort is host-side
    preprocessing, made anew each call: a caller that loops over modes keeps
    the CSFs (``cp_als`` does)."""
    factors = tuple(factors)
    return stream_mttkrp(_coo_csf(indices, values, factors, mode, out_rows), factors, config,
                         psram=psram, adc_bits=adc_bits)
