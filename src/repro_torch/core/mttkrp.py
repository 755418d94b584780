"""MTTKRP — Matricized Tensor Times Khatri-Rao Product — dense & sparse.

For a 3-mode tensor X (I,J,K) and factors B (J,R), C (K,R), mode-0 MTTKRP is

    A(i,r) = sum_{j,k} X(i,j,k) * B(j,r) * C(k,r)
           = X_(0) @ (C ⊙ B)        (⊙ = Khatri-Rao / column-wise Kronecker)

Paths ported (all N-mode generic):
  * ``mttkrp_dense``        — exact einsum chain.
  * ``mttkrp_dense_kr``     — the textbook matricized form (materializes the
                              Khatri-Rao product; used as an oracle).
  * ``mttkrp_sparse``       — COO scatter-add; the paper's CP1→CP2→CP3
                              chain vectorized over nonzeros.
  * ``mttkrp_sparse_psram`` — the same chain through the pSRAM quantized
                              numerics (``cp_chain_psram``: 8-bit operands
                              and the ADC on every product, §IV / Fig. 4).
  * ``mttkrp_sparse_psram_scheduled`` / ``mttkrp_sparse_blocked`` — the COO
                              front doors of ``repro_torch.sparse.stream``'s
                              quantized stream and flat blocked fold.

The dense matricized-KR MTTKRP on the array (exact and quantized, the
Khatri-Rao product formed on the fly) lives with its kernels in
``repro_torch.kernels.mttkrp``.
"""
from __future__ import annotations

import string

import torch

from repro_torch._device import ieee_f32
from repro_torch.core.quantization import ADCConfig, QMAX, adc_requantize, quantize_symmetric
from repro_torch.kernels.ordered_fold import (CHAIN_LONG_RUN, chain_coords, chain_long_runs,
                                              ordered_chain_fold, ordered_fold, row_runs)


def khatri_rao(mats: list[torch.Tensor]) -> torch.Tensor:
    """Column-wise Kronecker product: (prod(I_n), R) from [(I_n, R)]."""
    out = mats[0]
    for m in mats[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[-1])
    return out


def matricize(x: torch.Tensor, mode: int) -> torch.Tensor:
    """Mode-n unfolding X_(n): (I_n, prod of the other dims in order)."""
    order = [mode] + [d for d in range(x.ndim) if d != mode]
    return x.permute(order).reshape(x.shape[mode], -1)


@ieee_f32()
def mttkrp_dense(x: torch.Tensor, factors: list[torch.Tensor], mode: int) -> torch.Tensor:
    """Exact dense MTTKRP via a single einsum (mode-generic), in IEEE f32
    whatever TF32 setting the caller chose."""
    n = x.ndim
    letters = string.ascii_lowercase
    operands, subs = [x], [letters[:n]]
    for d in range(n):
        if d == mode:
            continue
        operands.append(factors[d])
        subs.append(letters[d] + "r")
    expr = ",".join(subs) + "->" + letters[mode] + "r"
    return torch.einsum(expr, *operands)


@ieee_f32()
def mttkrp_dense_kr(x: torch.Tensor, factors: list[torch.Tensor], mode: int) -> torch.Tensor:
    """Oracle: X_(n) @ KhatriRao(other factors) — materializes the KR operand.

    Column ordering of the unfolding follows :func:`matricize` (other modes in
    increasing order, row-major), so the KR factor list uses the same order.
    """
    others = [factors[d] for d in range(x.ndim) if d != mode]
    return matricize(x, mode) @ khatri_rao(others)


# ---------------------------------------------------------------------------
# sparse (COO)
# ---------------------------------------------------------------------------

def cp_chain_exact(indices, values, factors, mode) -> torch.Tensor:
    """CP1 + CP2 over the nonzero stream, exact floats: the (..., R) chain
    matrix ``d_p = x_p · ⊙ other-factor rows``. Shared by the scatter-add
    path below and the streaming executor (repro_torch.sparse.stream).
    ``indices``/``values`` may carry leading batch dims; every op is
    pointwise per nonzero, so blocking cannot change a single bit."""
    had = None
    for d in range(len(factors)):
        if d == mode:
            continue
        rows = factors[d][indices[..., d].long()]   # (..., R)  gather
        had = rows if had is None else had * rows   # CP 1
    return values[..., None] * had                  # CP 2


def cp_chain_psram(indices, values, factors, mode, adc_bits: int = 16) -> torch.Tensor:
    """CP1 + CP2 through the array numerics: each product passes 8-bit
    operand quantization and the ADC (per-row scale for the stored operand,
    per-vector intensity scale for the driven one). Shared by the
    scatter-add path below and the streaming executor. Like
    :func:`cp_chain_exact`, accepts leading batch dims (every scale is a
    per-nonzero reduction over the last axis, so blocking cannot change a
    single bit)."""
    others = [d for d in range(len(factors)) if d != mode]
    return psram_chain([factors[d][indices[..., d].long()] for d in others], values, adc_bits)


def psram_chain(rows, values: torch.Tensor, adc_bits: int = 16) -> torch.Tensor:
    """:func:`cp_chain_psram` over the gathered rows ``rows`` (the non-target
    factors' rows of each nonzero, ``(..., R)`` each, in mode order): CP1
    folds them pairwise through the ADC (requantize the running Hadamard,
    quantize the next row, digitize the integer product), CP2 drives the
    value through it once more. Every division is a true division and every
    rounding half to even (``quantize_symmetric``, ``adc_requantize``), the
    ops the chain routes of ``kernels.ordered_fold`` and
    ``kernels.segment_sum`` repeat bit for bit."""
    adc = ADCConfig(bits=adc_bits)
    full_scale = float(QMAX) * float(QMAX)

    def q(v):
        qv, s = quantize_symmetric(v, axis=-1)
        return qv.to(torch.int32), s

    q0, s0 = q(rows[0])
    had = q0.to(torch.float32) * s0
    for row in rows[1:]:                           # CP 1
        qa, sa = q(had)
        qb, sb = q(row)
        had = adc_requantize(qa * qb, adc, full_scale) * (sa * sb)
    qv, sv = q(values[..., None])                  # CP 2
    qh, sh = q(had)
    return adc_requantize(qv * qh, adc, full_scale) * (sv * sh)


def mttkrp_sparse(
    indices: torch.Tensor,     # (nnz, nmodes) int
    values: torch.Tensor,      # (nnz,) float
    factors: tuple,            # tuple of (I_n, R)
    mode: int,
    out_rows: int,
) -> torch.Tensor:
    """COO MTTKRP = the paper's CP1→CP2→CP3 chain vectorized over nonzeros.

    CP1: Hadamard of the gathered factor rows of all non-target modes.
    CP2: scale by the nonzero value.
    CP3: scatter-add into the target factor row, in stream order.

    Fold order: the nonzeros are stably sorted by their target row (which
    keeps each row's input order), the chain runs over the sorted stream
    (pointwise per nonzero, so its bits do not change), and each row's
    contributions are added in that order: the order of one global
    ``jax.ops.segment_sum`` over the unsorted stream. The result is
    **bit-identical** to the reference's on the CPU and, on the card, to the
    CPU's and repeatable from run to run. On the card CP1–CP3 are one launch
    of ``kernels.ordered_fold``'s chain route (a CTA per row); on the CPU the
    chain is formed eagerly and ``index_add_`` folds it. The sort is made once
    per mode and kept with ``indices`` (:func:`_sorted_stream`).
    """
    return _sorted_fold(indices, values, tuple(factors), mode, out_rows, False, 16)


def mttkrp_sparse_psram(
    indices: torch.Tensor,
    values: torch.Tensor,
    factors: tuple,
    mode: int,
    out_rows: int,
    adc_bits: int = 16,
) -> torch.Tensor:
    """COO MTTKRP through the pSRAM array numerics (§IV, Figs. 3-4).

    Each CP1/CP2 product passes through 8-bit operand quantization and the
    ADC (:func:`cp_chain_psram`); CP3 accumulates post-ADC in the electrical
    domain (exact adds), in the fold order of :func:`mttkrp_sparse`. The
    result is **bit-identical** to the reference's run op by op (its jitted
    form rewrites ``amax / 127`` into a reciprocal multiply and lands within
    one ADC code of it), and on the card to the CPU's: one launch of the
    ordered fold's chain route with the quantized chain formed in the
    kernel, so no ``(nnz, R)`` chain exists there.
    """
    return _sorted_fold(indices, values, tuple(factors), mode, out_rows, True, adc_bits)


def _sorted_fold(indices, values, factors: tuple, mode: int, out_rows: int, psram: bool,
                 adc_bits: int) -> torch.Tensor:
    """The chain (exact or quantized) over the stably sorted stream, folded
    in stream order: one chain-route launch on the card, the eager chain and
    ``index_add_`` on the CPU."""
    out = torch.zeros((out_rows, factors[0].shape[-1]), dtype=torch.float32,
                      device=values.device)
    if values.is_cuda:
        perm, coords, runs, longest, ranges, long_runs = _sorted_stream(indices, mode, out_rows)
        for (low, high), d in zip(ranges, (d for d in range(len(factors)) if d != mode)):
            if low < 0 or high >= factors[d].shape[0]:
                raise IndexError(f"mode {d}'s coordinates span [{low}, {high}], outside "
                                 f"factor {d}'s {factors[d].shape[0]} rows")
        return ordered_chain_fold(out, coords, values[perm],
                                  tuple(f.contiguous() for f in factors), mode, runs,
                                  longest_run=longest, long_runs=long_runs, psram=psram,
                                  adc_bits=adc_bits)
    perm, sorted_idx = _sorted_stream(indices, mode, out_rows)
    scaled = (cp_chain_psram(sorted_idx, values[perm], factors, mode, adc_bits) if psram
              else cp_chain_exact(sorted_idx, values[perm], factors, mode))
    return ordered_fold(out, scaled, sorted_idx[:, mode])  # CP 3


def mttkrp_sparse_psram_scheduled(indices, values, factors: tuple, mode: int, out_rows: int,
                                  config=None) -> torch.Tensor:
    """COO MTTKRP lowered through the streaming schedule (§IV, Figs. 3-4):
    the nonzeros sorted into a mode-rooted CSF, the quantized chain streamed
    in blocks of ``config.rows`` and folded electrically into the output
    rows (``repro_torch.sparse.stream.stream_mttkrp_coo`` with
    ``psram=True``) — bit-for-bit :func:`mttkrp_sparse_psram` on the sorted
    stream. The sort is host-side preprocessing."""
    from repro_torch.sparse.stream import stream_mttkrp_coo

    return stream_mttkrp_coo(indices, values, tuple(factors), mode, out_rows,
                             config=config, psram=True)


def mttkrp_sparse_blocked(indices, values, factors: tuple, mode: int, out_rows: int,
                          config=None, psram: bool = False, adc_bits: int = 16) -> torch.Tensor:
    """Sparse MTTKRP under the *blocked-segment fold*: the flat twin of the
    compiled streaming executor (``repro_torch.sparse.stream.
    blocked_fold_mttkrp_coo``). The stream is sorted into a mode-rooted CSF,
    cut into blocks of ``config.rows``, each block's segment sums taken as
    one gather-mask contraction and the partials scattered into the output
    rows in block order. Against the per-nonzero fold it is the same
    arithmetic reassociated (~1e-6 relative on well-conditioned operands).
    Host-side sort."""
    from repro_torch.sparse.stream import blocked_fold_mttkrp_coo

    return blocked_fold_mttkrp_coo(indices, values, tuple(factors), mode, out_rows,
                                   config=config, psram=psram, adc_bits=adc_bits)


def _sorted_stream(indices: torch.Tensor, mode: int, out_rows: int):
    """The stable sort ``perm`` of the nonzeros by their ``mode`` coordinate
    and what each device's path reads of the sorted stream: on the CPU
    ``(perm, indices[perm])``; on a CUDA device ``(perm, coords, runs,
    longest, ranges, long_runs)`` — the non-target coordinates in the chain
    route's layout (``kernels.ordered_fold.chain_coords``), the target rows'
    runs (``row_runs``), the most nonzeros a row has, each non-target mode's
    coordinate range ``(low, high)``, for the caller to hold against its
    factors, and the rows the quantized route gives a cluster
    (``chain_long_runs``, found once here with the runs on the host). The
    target coordinates are checked here, against ``out_rows`` (on the card
    nothing else would: the chain route trusts its runs). A
    CP-ALS run asks for every mode once a sweep of the same COO, so the
    result is kept on ``indices`` per ``(mode, out_rows)`` and made anew only
    once the tensor has been written in place (its version counter moved)."""
    cache = indices.__dict__.setdefault("_sorted_stream", {})
    key = (mode, out_rows)
    hit = cache.get(key)
    if hit is not None and hit[0] == indices._version:
        return hit[1]
    ids, perm = torch.sort(indices[:, mode].long(), stable=True)
    if not ids.is_cuda:
        entry = (perm, indices[perm])
    else:
        sorted_idx = indices[perm]
        runs = row_runs(ids, out_rows)
        longest, ranges, long_runs = 0, [], runs.new_zeros(0)
        if ids.numel():                      # one sync, made with the sort and kept
            most = runs.diff().max()[None] if out_rows else ids.new_zeros(1)
            stats = torch.cat([most, ids[[0, -1]],
                               torch.stack([sorted_idx.amin(0), sorted_idx.amax(0)], 1)
                               .reshape(-1).long()]).tolist()
            longest, (low, high) = stats[0], stats[1:3]
            if low < 0 or high >= out_rows:
                raise IndexError(f"mode {mode}'s coordinates span [{low}, {high}], outside "
                                 f"its {out_rows} output rows")
            ranges = [(stats[3 + 2 * d], stats[4 + 2 * d])
                      for d in range(indices.shape[1]) if d != mode]
            if longest >= CHAIN_LONG_RUN:
                long_runs = torch.as_tensor(chain_long_runs(runs.cpu().numpy()),
                                            device=runs.device)
        entry = (perm, chain_coords(sorted_idx, mode), runs, longest, ranges, long_runs)
    cache[key] = (indices._version, entry)
    return entry


def dense_to_coo(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """All-entries COO of a dense tensor (for cross-checking paths)."""
    grids = torch.meshgrid(
        *[torch.arange(s, device=x.device) for s in x.shape], indexing="ij")
    idx = torch.stack(grids, dim=-1).reshape(-1, x.ndim)
    return idx.to(torch.int32), x.reshape(-1)
