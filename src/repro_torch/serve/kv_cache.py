"""Paged KV-cache manager for continuous batching.

Production serving does not give every request a seq_len-sized cache slab:
requests arrive and finish continuously and memory is managed in fixed-size
pages (vLLM-style). This manager is the allocation layer on top of the
models' (B, S, Hkv, hd) cache tensors:

  * the physical cache holds `num_pages` pages of `page_size` tokens;
  * each sequence owns a page table (logical block -> physical page);
  * admission succeeds only if the free list can cover the prompt and one
    decode page (reservation against deadlock);
  * freeing a finished request returns its pages to the free list.

The page tables are plain numpy on the host (they change shape with request
churn); only the *physical* cache lives on the device. ``gather_cache``
builds the dense view of a request's slots from the flat paged cache, a
torch tensor (the serve loop's slab, :mod:`repro_torch.serve.loop`).

A port of ``repro.serve.kv_cache``: the same tables, free lists and pop
order, so the same request stream lands in the same physical slots.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class PagedCacheConfig:
    num_pages: int
    page_size: int = 128

    @property
    def capacity_tokens(self) -> int:
        return self.num_pages * self.page_size


class PagedKVManager:
    def __init__(self, cfg: PagedCacheConfig):
        self.cfg = cfg
        self.free: list[int] = list(range(cfg.num_pages))
        self.tables: dict[int, list[int]] = {}   # request id -> physical pages
        self.lengths: dict[int, int] = {}        # tokens written per request

    # ------------------------------------------------------------ admission
    def pages_needed(self, tokens: int) -> int:
        return (tokens + self.cfg.page_size - 1) // self.cfg.page_size

    def can_admit(self, prompt_len: int) -> bool:
        return len(self.free) >= self.pages_needed(prompt_len) + 1

    def admit(self, rid: int, prompt_len: int) -> bool:
        if rid in self.tables or not self.can_admit(prompt_len):
            return False
        n = self.pages_needed(prompt_len)
        self.tables[rid] = [self.free.pop() for _ in range(n)]
        self.lengths[rid] = prompt_len
        return True

    # ------------------------------------------------------------- decoding
    def extend(self, rid: int, new_tokens: int = 1) -> bool:
        """Grow a sequence; allocates a page when it crosses a boundary.

        An unknown ``rid`` raises ``KeyError`` before any allocation — a
        typo'd id must not pop pages off the free list for a table nobody
        owns."""
        if rid not in self.tables:
            raise KeyError(
                f"unknown request id {rid!r}: extend() is only valid for "
                "admitted requests")
        cur = self.lengths[rid]
        need = self.pages_needed(cur + new_tokens) - len(self.tables[rid])
        if need > len(self.free):
            return False
        for _ in range(need):
            self.tables[rid].append(self.free.pop())
        self.lengths[rid] = cur + new_tokens
        return True

    def free_request(self, rid: int):
        """Release a request's pages. A never-admitted (or already freed)
        ``rid`` is a no-op — the serve loop frees on every exit path
        (finish, preempt, reject) without tracking which ran first."""
        pages = self.tables.pop(rid, None)
        if pages is None:
            return
        self.free.extend(pages)
        self.lengths.pop(rid)

    # ------------------------------------------------------------ addressing
    def physical_slots(self, rid: int) -> np.ndarray:
        """Physical token slots (into the flat paged cache) for a request."""
        pages = np.asarray(self.tables[rid])
        length = self.lengths[rid]
        slots = (
            pages[:, None] * self.cfg.page_size
            + np.arange(self.cfg.page_size)[None, :]
        ).reshape(-1)
        return slots[:length]

    @property
    def allocated_pages(self) -> int:
        """Pages currently owned by live requests — 0 at full drain (the
        serve loop's leak check)."""
        return self.cfg.num_pages - len(self.free)

    def utilization(self) -> float:
        return self.allocated_pages / self.cfg.num_pages

    def fragmentation(self) -> float:
        """Allocated-but-unwritten fraction (internal fragmentation)."""
        alloc_tokens = sum(len(t) for t in self.tables.values()) * self.cfg.page_size
        if alloc_tokens == 0:
            return 0.0
        written = sum(self.lengths.values())
        return 1.0 - written / alloc_tokens


def gather_cache(flat_cache, slots, dim: int = 0):
    """Dense view of the slots ``slots`` from the flat paged cache.

    flat_cache: a tensor whose axis ``dim`` is the token slot,
    (num_pages * page_size, Hkv, hd)-like at ``dim=0``; slots: an int array
    from physical_slots() (numpy, or a tensor on the cache's device), of any
    shape, which replaces axis ``dim`` in the result. One ``index_select``:
    one launch on the card."""
    if not isinstance(slots, torch.Tensor):
        slots = torch.as_tensor(np.asarray(slots, np.int64), device=flat_cache.device)
    return flat_cache.index_select(dim, slots.reshape(-1)).unflatten(dim, tuple(slots.shape))
