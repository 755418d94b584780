"""FROSTT-style synthetic sparse tensors with controllable fiber skew.

Real decomposition tensors (NELL, Amazon, Reddit…) have power-law fiber
lengths: a few output rows own a large share of the nonzeros while most rows
hold a handful. The generator makes that skew a first-class knob: rows of
``mode`` are drawn from a Zipf-like distribution with exponent ``alpha``
(``alpha=0`` → uniform), other modes uniformly.

Values come from a low-rank CP model so CP-ALS on the generated tensor has
structure to recover; duplicates are merged so the COO is a function of its
coordinates. Everything random comes from ``np.random.default_rng(seed)`` —
the same integer seed yields the same tensor as the reference generator
does once it has turned its key into that integer.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .formats import SortedCOO


def _zipf_rows(rng: np.random.Generator, n_rows: int, nnz: int,
               alpha: float) -> np.ndarray:
    """Sample ``nnz`` row ids with p(row r) ∝ (r+1)^-alpha over a random
    permutation of the rows (so heavy rows are scattered, not the prefix)."""
    weights = (np.arange(1, n_rows + 1, dtype=np.float64)) ** (-alpha)
    weights /= weights.sum()
    ranks = rng.choice(n_rows, size=nnz, p=weights)
    perm = rng.permutation(n_rows)
    return perm[ranks]


def powerlaw_coo(seed: int, shape: tuple[int, ...], nnz: int, rank: int = 8,
                 alpha: float = 1.1, mode: int = 0, noise: float = 0.0,
                 device="cuda") -> SortedCOO:
    """Synthetic COO tensor: power-law fibers along ``mode``, low-rank values.

    ``nnz`` is the *requested* sample count; duplicates are merged, so the
    resulting tensor holds at most ``nnz`` nonzeros. ``alpha`` controls the
    fiber-length skew of ``mode`` (0 = uniform, >1 = heavy head). The
    result is sorted by the natural mode order and lives on ``device``.
    """
    rng = np.random.default_rng(int(seed))
    idx = np.empty((nnz, len(shape)), dtype=np.int64)
    for d, s in enumerate(shape):
        if d == mode:
            idx[:, d] = _zipf_rows(rng, s, nnz, alpha)
        else:
            idx[:, d] = rng.integers(0, s, size=nnz)
    factors = [rng.standard_normal((s, rank)) / np.sqrt(rank) for s in shape]
    # CP value model: sum over rank of the product of factor entries — the
    # tensor restricted to its support really is rank-`rank`
    prod = np.ones((nnz, rank))
    for d in range(len(shape)):
        prod *= factors[d][idx[:, d]]
    vals = prod.sum(axis=1)
    if noise > 0:
        vals = vals + noise * rng.standard_normal(nnz)
    # merge duplicate coordinates so formats/round-trips are well-defined
    return SortedCOO.sort_numpy(
        idx.astype(np.int32), vals.astype(np.float32), tuple(shape),
        tuple(range(len(shape))), dedupe=True, device=device)


@dataclasses.dataclass(frozen=True)
class FiberStats:
    """Summary of a fiber-length distribution (nonzeros per output row)."""

    n_fibers: int
    nnz: int
    mean: float
    max: int
    p50: float
    p99: float

    @classmethod
    def of(cls, fiber_lengths: np.ndarray) -> "FiberStats":
        f = np.asarray(fiber_lengths)
        f = f[f > 0]
        if not len(f):
            return cls(0, 0, 0.0, 0, 0.0, 0.0)
        return cls(
            n_fibers=int(len(f)),
            nnz=int(f.sum()),
            mean=float(f.mean()),
            max=int(f.max()),
            p50=float(np.percentile(f, 50)),
            p99=float(np.percentile(f, 99)),
        )


def powerlaw_fiber_lengths(seed: int, n_rows: int, nnz: int,
                           alpha: float = 1.1) -> np.ndarray:
    """Just the fiber-length distribution (for paper-scale accounting where
    materializing coordinates would be pointless): nonzeros per nonempty
    row, in row order."""
    rng = np.random.default_rng(seed)
    rows = _zipf_rows(rng, n_rows, nnz, alpha)
    counts = np.bincount(rows, minlength=n_rows)
    return counts[counts > 0].astype(np.int64)
