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


def mttkrp_dense(x: torch.Tensor, factors: list[torch.Tensor], mode: int) -> torch.Tensor:
    """Exact dense MTTKRP via a single einsum (mode-generic)."""
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
    CP3: scatter-add into the target factor row (``index_add_``).

    Fold order: on the CPU ``index_add_`` adds in stream order; on a CUDA
    device it uses atomics, so the adds land in no fixed order and the
    result may differ in the last bits from run to run. The reference's
    bit-identity of this eager path to an ordered segment sum is therefore
    **not** claimed here yet — it arrives with the ordered fold of the
    ``psram-stream`` slice.
    """
    scaled = cp_chain_exact(indices, values, factors, mode)
    out = torch.zeros((out_rows, scaled.shape[-1]), dtype=scaled.dtype,
                      device=scaled.device)
    return out.index_add_(0, indices[:, mode].long(), scaled)  # CP 3


def dense_to_coo(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """All-entries COO of a dense tensor (for cross-checking paths)."""
    grids = torch.meshgrid(
        *[torch.arange(s, device=x.device) for s in x.shape], indexing="ij")
    idx = torch.stack(grids, dim=-1).reshape(-1, x.ndim)
    return idx.to(torch.int32), x.reshape(-1)
