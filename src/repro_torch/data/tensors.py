"""Synthetic tensors for the CP-ALS / MTTKRP experiments: exact low-rank
dense tensors (known ground truth) and sparse COO tensors with configurable
density — the tensor-decomposition analogue of the LM token pipeline.

The reference draws with ``jax.random`` (threefry bits the port cannot
reproduce). The port draws from its own ``torch.Generator`` on the CPU,
seeded with the integer ``seed`` — never from the global RNG — and moves
the draws to ``device``, so the same seed gives the same draws on every
device. The draws are the reference's in distribution (uniform factors,
normal noise, uniform coordinates), not in bits; the arithmetic on them is
the reference's. Port of the reference module whole.
"""
from __future__ import annotations

import torch

from repro_torch._device import as_device, ieee_f32
from repro_torch.core.cp_als import reconstruct


def _generator(seed: int) -> torch.Generator:
    gen = torch.Generator()
    gen.manual_seed(int(seed))
    return gen


def lowrank_dense(seed: int, shape: tuple[int, ...], rank: int,
                  noise: float = 0.0, device="cuda"):
    """``(x, factors)``: the dense f32 tensor ``reconstruct(factors)`` of
    uniform [0, 1) factors ``(s, rank)`` a mode, plus ``noise`` times
    standard-normal entries, on ``device``."""
    dev = as_device(device)
    gen = _generator(seed)
    factors = [torch.rand((s, rank), generator=gen).to(dev) for s in shape]
    with ieee_f32():
        x = reconstruct(factors)
    if noise > 0:
        x = x + noise * torch.randn(tuple(x.shape), generator=gen).to(dev)
    return x, factors


def sparse_coo(seed: int, shape: tuple[int, ...], nnz: int, rank: int = 4,
               device="cuda"):
    """``(indices, values, shape)``: ``nnz`` uniformly sampled coordinates
    (int32 ``(nnz, ndim)``, duplicates kept) whose values come from a
    rank-``rank`` model (so CP-ALS can recover structure): the product over
    modes of each coordinate's factor row summed and divided by ``rank``."""
    dev = as_device(device)
    gen = _generator(seed)
    idx = torch.stack([torch.randint(0, s, (nnz,), generator=gen) for s in shape],
                      dim=1).to(device=dev, dtype=torch.int32)
    factors = [torch.rand((s, rank), generator=gen).to(dev) for s in shape]
    vals = torch.ones((nnz,), device=dev)
    for d in range(len(shape)):
        rows = factors[d][idx[:, d].long()]
        vals = vals * torch.sum(rows, dim=1) / rank
    return idx, vals, tuple(shape)
