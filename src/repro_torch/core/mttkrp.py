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

The dense matricized-KR MTTKRP on the array (exact and quantized, the
Khatri-Rao product formed on the fly) lives with its kernels in
``repro_torch.kernels.mttkrp``. Still to come from the reference module: the
quantized chain (``cp_chain_psram``, ``mttkrp_sparse_psram``,
``…_scheduled``) and the flat blocked fold (``mttkrp_sparse_blocked``).
"""
from __future__ import annotations

import string

import torch

from repro_torch._device import ieee_f32
from repro_torch.kernels.ordered_fold import (chain_coords, ordered_chain_fold, ordered_fold,
                                              row_runs)


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
    factors = tuple(factors)
    if values.is_cuda:
        perm, coords, runs, longest, ranges = _sorted_stream(indices, mode, out_rows)
        for (low, high), d in zip(ranges, (d for d in range(len(factors)) if d != mode)):
            if low < 0 or high >= factors[d].shape[0]:
                raise IndexError(f"mode {d}'s coordinates span [{low}, {high}], outside "
                                 f"factor {d}'s {factors[d].shape[0]} rows")
        out = torch.zeros((out_rows, factors[0].shape[-1]), dtype=torch.float32,
                          device=values.device)
        return ordered_chain_fold(out, coords, values[perm],
                                  tuple(f.contiguous() for f in factors), mode, runs,
                                  longest_run=longest)
    perm, sorted_idx = _sorted_stream(indices, mode, out_rows)
    scaled = cp_chain_exact(sorted_idx, values[perm], factors, mode)
    out = torch.zeros((out_rows, scaled.shape[-1]), dtype=scaled.dtype,
                      device=scaled.device)
    return ordered_fold(out, scaled, sorted_idx[:, mode])  # CP 3


def _sorted_stream(indices: torch.Tensor, mode: int, out_rows: int):
    """The stable sort ``perm`` of the nonzeros by their ``mode`` coordinate
    and what each device's path reads of the sorted stream: on the CPU
    ``(perm, indices[perm])``; on a CUDA device ``(perm, coords, runs,
    longest, ranges)`` — the non-target coordinates in the chain route's
    layout (``kernels.ordered_fold.chain_coords``), the target rows' runs
    (``row_runs``), the most nonzeros a row has, and each non-target mode's
    coordinate range ``(low, high)``, for the caller to hold against its
    factors. The target coordinates are checked here, against ``out_rows``
    (on the card nothing else would: the chain route trusts its runs). A
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
        longest, ranges = 0, []
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
        entry = (perm, chain_coords(sorted_idx, mode), runs, longest, ranges)
    cache[key] = (indices._version, entry)
    return entry


def dense_to_coo(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """All-entries COO of a dense tensor (for cross-checking paths)."""
    grids = torch.meshgrid(
        *[torch.arange(s, device=x.device) for s in x.shape], indexing="ij")
    idx = torch.stack(grids, dim=-1).reshape(-1, x.ndim)
    return idx.to(torch.int32), x.reshape(-1)
