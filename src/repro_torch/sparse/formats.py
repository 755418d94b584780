"""Sparse-tensor containers for the pSRAM MTTKRP engine.

Formats, each one preprocessing step closer to the streaming schedule
(``repro_torch.sparse.stream``):

* :class:`COO` — the raw triple ``(indices, values, shape)``. What loaders
  and synthetic generators produce; no ordering guarantees.
* :class:`SortedCOO` — COO sorted lexicographically by a *mode order*
  (target mode first). Sorting by the output mode is what makes CP3's
  scatter a run of contiguous segments — the precondition for streaming
  nonzero blocks through the array without a scatter matrix.
* :class:`BlockedCOO` — a SortedCOO partitioned into blocks of at most
  ``block_size`` nonzeros (one pSRAM tile's worth of word-lines each).
* :class:`CSF` — compressed sparse fiber (SPLATT-style): one tree level per
  mode in ``mode_order``, ``fids[l]``/``fptr[l]`` per level, values at the
  leaves.

Construction happens host-side in numpy (this is offline preprocessing, the
analogue of SPLATT's tensor build); the arrays carried by the containers
are torch tensors on the container's device — the device of the tensors a
container was built from, or the explicit ``device=`` of the constructors
that start from host data.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import as_device


def _as_np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _lex_perm(idx: np.ndarray, order: tuple[int, ...],
              shape: tuple[int, ...]) -> np.ndarray:
    """The stable lexicographic sort permutation of ``idx`` by ``order``
    (first entry primary) — what ``np.lexsort`` returns. When the shape
    product fits one int64 the coordinates are packed into a single key and
    sorted once (a stable sort of the packed key is the same permutation,
    several times cheaper on FROSTT-scale streams)."""
    size = 1
    for s in shape:
        size *= int(s)
    if size < 2 ** 62 and len(idx):
        key = np.zeros(len(idx), dtype=np.int64)
        for m in order:
            key = key * int(shape[m]) + idx[:, m]
        return np.argsort(key, kind="stable")
    # np.lexsort: last key is primary, so feed mode_order reversed
    return np.lexsort(tuple(idx[:, m] for m in reversed(order)))


@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate-format sparse tensor: ``values[p]`` at ``indices[p, :]``."""

    indices: torch.Tensor   # (nnz, nmodes) int32
    values: torch.Tensor    # (nnz,) float32
    shape: tuple[int, ...]

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @property
    def nmodes(self) -> int:
        return len(self.shape)

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def density(self) -> float:
        size = 1
        for s in self.shape:
            size *= s
        return self.nnz / max(1, size)

    def validate(self) -> None:
        idx = _as_np(self.indices)
        if idx.ndim != 2 or idx.shape[1] != self.nmodes:
            raise ValueError(f"indices {idx.shape} vs {self.nmodes}-mode shape")
        if idx.shape[0] != self.nnz:
            raise ValueError("indices/values length mismatch")
        if self.nnz:
            if idx.min() < 0:
                raise ValueError("negative coordinate")
            over = idx.max(axis=0) >= np.asarray(self.shape)
            if over.any():
                raise ValueError(
                    f"coordinates exceed shape {self.shape} on modes "
                    f"{np.flatnonzero(over).tolist()}"
                )

    def to_dense(self) -> torch.Tensor:
        """Materialize (small tensors only — for cross-checking paths)."""
        out = torch.zeros(self.shape, dtype=torch.float32, device=self.device)
        return out.index_put_(tuple(self.indices.long().T), self.values,
                              accumulate=True)

    @classmethod
    def from_dense(cls, x: torch.Tensor, keep_zeros: bool = False) -> "COO":
        """COO of a dense tensor, on ``x``'s device."""
        xn = _as_np(x)
        if keep_zeros:
            idx = np.indices(xn.shape).reshape(xn.ndim, -1).T
        else:
            idx = np.argwhere(xn != 0)
        vals = xn[tuple(idx.T)]
        return cls.from_numpy(idx, vals, tuple(xn.shape), device=x.device)

    @classmethod
    def from_numpy(cls, indices, values, shape, device="cuda", **fields):
        """Container over host arrays, copied to ``device`` (never an alias
        of the caller's arrays, also on the CPU)."""
        dev = as_device(device)
        return cls(
            indices=torch.tensor(np.asarray(indices, dtype=np.int32), device=dev),
            values=torch.tensor(np.asarray(values, dtype=np.float32), device=dev),
            shape=tuple(int(s) for s in shape),
            **fields,
        )


@dataclasses.dataclass(frozen=True)
class SortedCOO(COO):
    """COO sorted lexicographically by ``mode_order`` (first entry primary).

    ``mode_order[0]`` is the MTTKRP target mode: its coordinates are
    non-decreasing along the nonzero stream, so every output row is a
    contiguous segment — the invariant the streaming scheduler relies on.
    """

    mode_order: tuple[int, ...] = ()

    def validate(self) -> None:
        super().validate()
        if sorted(self.mode_order) != list(range(self.nmodes)):
            raise ValueError(f"mode_order {self.mode_order} is not a permutation")
        idx = _as_np(self.indices)
        if self.nnz < 2:
            return
        # lexicographic check column by column
        ordered = idx[:, list(self.mode_order)].astype(np.int64)
        a, b = ordered[:-1], ordered[1:]
        diff = a != b
        first = np.argmax(diff, axis=1)          # first differing mode
        pos = np.arange(len(a))
        bad = diff.any(axis=1) & (a[pos, first] > b[pos, first])
        if bad.any():
            raise ValueError("indices are not sorted by mode_order")

    @classmethod
    def from_coo(cls, coo: COO, mode_order: tuple[int, ...] | None = None,
                 dedupe: bool = False) -> "SortedCOO":
        order = tuple(mode_order) if mode_order is not None \
            else tuple(range(coo.nmodes))
        return cls.sort_numpy(_as_np(coo.indices), _as_np(coo.values),
                              coo.shape, order, dedupe, coo.device)

    @classmethod
    def sort_numpy(cls, idx: np.ndarray, vals: np.ndarray, shape, order,
                   dedupe: bool, device) -> "SortedCOO":
        """Sort (and optionally merge duplicates of) host arrays, then
        upload once to ``device``. ``vals`` must already be float32 — the
        duplicate merge sums in double and rounds back to its dtype."""
        perm = _lex_perm(idx, order, shape)
        idx, vals = idx[perm], vals[perm]
        if dedupe and len(vals):
            same = np.all(idx[1:] == idx[:-1], axis=1)
            starts = np.flatnonzero(np.concatenate(([True], ~same)))
            seg = np.repeat(np.arange(len(starts)),
                            np.diff(np.concatenate((starts, [len(vals)]))))
            vals = np.bincount(seg, weights=vals).astype(vals.dtype)
            idx = idx[starts]
        return cls.from_numpy(idx, vals, shape, device=device,
                              mode_order=tuple(order))

    def fiber_lengths(self) -> np.ndarray:
        """Nonzeros per (nonempty) output row of the target mode, row order."""
        rows = _as_np(self.indices)[:, self.mode_order[0]]
        if not len(rows):
            return np.zeros(0, dtype=np.int64)
        starts = np.flatnonzero(np.concatenate(([True], np.diff(rows) != 0)))
        return np.diff(np.concatenate((starts, [len(rows)]))).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class BlockedCOO(SortedCOO):
    """SortedCOO cut into blocks of at most ``block_size`` nonzeros.

    ``block_ptr[b] : block_ptr[b+1]`` is the nonzero range one pSRAM tile
    holds.
    """

    block_size: int = 256
    block_ptr: tuple[int, ...] = (0,)

    @property
    def n_blocks(self) -> int:
        return len(self.block_ptr) - 1

    def validate(self) -> None:
        super().validate()
        ptr = np.asarray(self.block_ptr)
        if ptr[0] != 0 or ptr[-1] != self.nnz or (np.diff(ptr) <= 0).any():
            raise ValueError(f"bad block_ptr for nnz={self.nnz}")
        if (np.diff(ptr) > self.block_size).any():
            raise ValueError(f"a block exceeds block_size={self.block_size}")

    @classmethod
    def from_sorted(cls, s: SortedCOO, block_size: int) -> "BlockedCOO":
        if block_size < 1:
            raise ValueError("block_size must be positive")
        ptr = tuple(range(0, s.nnz, block_size)) + (s.nnz,) if s.nnz else (0,)
        return cls(
            indices=s.indices, values=s.values, shape=s.shape,
            mode_order=s.mode_order, block_size=block_size, block_ptr=ptr,
        )


@dataclasses.dataclass(frozen=True)
class CSF:
    """Compressed sparse fiber tree over ``mode_order``.

    ``fids[l]`` holds the mode-``mode_order[l]`` coordinate of each level-l
    fiber; ``fptr[l]`` maps a level-l fiber to its children range in level
    l+1 (so ``fptr`` has ``nmodes - 1`` entries). The last level is the leaf
    level: one entry per nonzero, aligned with ``values``. All nonzeros are
    stored in the lexicographic order of ``mode_order`` — the same order
    :class:`SortedCOO` uses, so CSF↔COO round-trips are exact including
    value order. The tree (``fids``/``fptr``) stays on the host in numpy;
    ``values`` and the expanded indices live on the container's device.
    """

    shape: tuple[int, ...]
    mode_order: tuple[int, ...]
    fids: tuple[np.ndarray, ...]   # per level, int32
    fptr: tuple[np.ndarray, ...]   # per internal level, int64, len = n_fids+1
    values: torch.Tensor           # (nnz,) float32, leaf order

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @property
    def nmodes(self) -> int:
        return len(self.shape)

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def n_fibers(self) -> tuple[int, ...]:
        return tuple(len(f) for f in self.fids)

    def validate(self) -> None:
        n = self.nmodes
        if sorted(self.mode_order) != list(range(n)):
            raise ValueError(f"mode_order {self.mode_order} is not a permutation")
        if len(self.fids) != n or len(self.fptr) != n - 1:
            raise ValueError("level count mismatch")
        if len(self.fids[-1]) != self.nnz:
            raise ValueError("leaf level must align with values")
        for l, (m, f) in enumerate(zip(self.mode_order, self.fids)):
            if len(f) and (f.min() < 0 or f.max() >= self.shape[m]):
                raise ValueError(f"level-{l} fiber ids out of range for mode {m}")
        for l, p in enumerate(self.fptr):
            if len(p) != len(self.fids[l]) + 1:
                raise ValueError(f"fptr[{l}] length mismatch")
            if p[0] != 0 or p[-1] != len(self.fids[l + 1]) \
                    or (np.diff(p) <= 0).any():
                raise ValueError(f"fptr[{l}] is not a monotone cover")

    # ------------------------------------------------------------ building

    @classmethod
    def from_coo(cls, coo: COO, mode_order: tuple[int, ...] | None = None,
                 dedupe: bool = False) -> "CSF":
        already_sorted = isinstance(coo, SortedCOO) and (
            mode_order is None or tuple(mode_order) == coo.mode_order
        )
        # the shortcut must not skip a requested duplicate merge
        s = coo if already_sorted and not dedupe \
            else SortedCOO.from_coo(coo, mode_order or getattr(coo, "mode_order", None), dedupe=dedupe)
        order = s.mode_order
        idx = _as_np(s.indices)
        n = s.nmodes
        nnz = s.nnz
        # new_l[p] — nonzero p starts a new level-l fiber (prefix of modes
        # order[0..l] changed). Cumulative OR down the levels: a coarser
        # boundary is always a finer one too.
        news: list[np.ndarray] = []
        new = np.zeros(nnz, dtype=bool)
        if nnz:
            new[0] = True
        for l in range(n):
            if l < n - 1:
                if nnz:
                    new = new.copy()
                    new[1:] |= idx[1:, order[l]] != idx[:-1, order[l]]
                news.append(new)
            else:
                news.append(np.ones(nnz, dtype=bool))  # leaves: every nonzero
        fids = tuple(
            idx[news[l], order[l]].astype(np.int32) for l in range(n)
        )
        fptr = []
        for l in range(n - 1):
            child_pos = np.flatnonzero(news[l + 1])
            own_pos = np.flatnonzero(news[l])
            # every coarse boundary is a fine boundary, so this is exact
            p = np.searchsorted(child_pos, own_pos).astype(np.int64)
            fptr.append(np.concatenate((p, [len(child_pos)])))
        csf = cls(
            shape=s.shape, mode_order=order, fids=fids, fptr=tuple(fptr),
            values=s.values,
        )
        # the sorted coordinates ARE the expansion: keep both copies rather
        # than rebuilding the repeat chain and re-uploading on first use
        csf.__dict__["_expanded_np"] = np.ascontiguousarray(idx, dtype=np.int32)
        csf.__dict__["_expanded"] = s.indices.to(torch.int32)
        return csf

    # ---------------------------------------------------------- conversion

    def expanded_indices_np(self) -> np.ndarray:
        """(nnz, nmodes) int32 in *original* mode positions, leaf order, on
        the host (what the layout preprocessing consumes). Cached."""
        cached = self.__dict__.get("_expanded_np")
        if cached is not None:
            return cached
        n = self.nmodes
        out = np.zeros((self.nnz, n), dtype=np.int32)
        for l in range(n):
            col = self.fids[l]
            # expand level-l fiber ids down to the leaves
            for p in self.fptr[l:]:
                col = np.repeat(col, np.diff(p))
            out[:, self.mode_order[l]] = col
        self.__dict__["_expanded_np"] = out  # frozen dataclass: bypass setattr
        return out

    def expanded_indices(self) -> torch.Tensor:
        """:meth:`expanded_indices_np` on the container's device. Cached on
        the instance (the tree is immutable and CP-ALS asks for the
        expansion once per sweep per mode)."""
        cached = self.__dict__.get("_expanded")
        if cached is not None:
            return cached
        out = torch.as_tensor(self.expanded_indices_np(), device=self.device)
        self.__dict__["_expanded"] = out
        return out

    def to_coo(self) -> SortedCOO:
        return SortedCOO(
            indices=self.expanded_indices(),
            values=self.values,
            shape=self.shape,
            mode_order=self.mode_order,
        )

    def fiber_lengths(self) -> np.ndarray:
        """Leaf count per root fiber — nonzeros per nonempty output row."""
        cached = self.__dict__.get("_fiber_lengths")
        if cached is not None:
            return cached
        counts = np.ones(len(self.fids[-1]), dtype=np.int64)
        for p in reversed(self.fptr):
            counts = np.add.reduceat(counts, p[:-1]) if len(p) > 1 \
                else counts[:0]
        self.__dict__["_fiber_lengths"] = counts
        return counts

    def row_of_nonzero(self) -> np.ndarray:
        """(nnz,) target-mode row of each leaf, leaf order (non-decreasing)."""
        cached = self.__dict__.get("_row_of_nonzero")
        if cached is not None:
            return cached
        col = self.fids[0]
        for p in self.fptr:
            col = np.repeat(col, np.diff(p))
        col = col.astype(np.int32)
        self.__dict__["_row_of_nonzero"] = col
        return col

    # --------------------------------------------------------- partitioning

    def slice_roots(self, start: int, stop: int) -> "CSF":
        """Sub-tensor holding root fibers ``start:stop`` (for multi-array
        partitioning) — fiber ids keep their original coordinates."""
        if not (0 <= start <= stop <= len(self.fids[0])):
            raise ValueError(f"root slice [{start}:{stop}) out of range")
        fids = [self.fids[0][start:stop]]
        fptr = []
        lo, hi = start, stop
        for l, p in enumerate(self.fptr):
            lo_c, hi_c = int(p[lo]), int(p[hi])
            fptr.append((p[lo:hi + 1] - p[lo]).astype(np.int64))
            fids.append(self.fids[l + 1][lo_c:hi_c])
            lo, hi = lo_c, hi_c
        return CSF(
            shape=self.shape, mode_order=self.mode_order,
            fids=tuple(fids), fptr=tuple(fptr),
            values=self.values[lo:hi],
        )


def csf_for_mode(coo: COO, mode: int, dedupe: bool = False) -> CSF:
    """CSF with ``mode`` as the root level — the layout mode-``mode``
    MTTKRP streams (target rows contiguous along the nonzero stream)."""
    order = (mode,) + tuple(d for d in range(coo.nmodes) if d != mode)
    return CSF.from_coo(coo, order, dedupe=dedupe)
