"""Deterministic, restart-exact data pipeline.

Batches are a pure function of ``(seed, step, host_index)``: after a
failure and restore at step k the stream resumes bit-identically with zero
coordination. Host-sharded iteration draws this host's rows of the global
batch by ``(host_index, host_count)`` (on one host, the whole batch).

Synthetic token streams follow a Zipfian unigram distribution with a
deterministic structure, the reference's: every third column replaced by
``roll(raw, 1) * 31 % V`` of the raw draws (a token that depends on the one
before it, something to learn beyond unigram frequencies), BOS (token 1)
written last at every ``bos_period``-th column, labels the tokens shifted by
one.

The reference draws with ``jax.random.categorical`` (threefry bits the port
cannot reproduce). The port draws from its own ``torch.Generator`` on the
CPU, seeded from ``numpy.random.SeedSequence((seed, step, host_index))`` —
never from the global RNG — so the stream is the same on every device and
after every restart; the draws are the reference's in distribution, not in
bits. Port of the reference module whole.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import as_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1
    bos_period: int = 64


def _zipf_probs(cfg: DataConfig) -> torch.Tensor:
    """The unigram: ``softmax(-alpha * log(rank))`` over ranks 1..V, f64."""
    ranks = torch.arange(1, cfg.vocab_size + 1, dtype=torch.float64)
    return torch.softmax(-cfg.zipf_alpha * torch.log(ranks), dim=0)


def _generator(cfg: DataConfig, step: int, host_index: int) -> torch.Generator:
    seed = np.random.SeedSequence((cfg.seed, step, host_index)).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed))


def batch_at_step(cfg: DataConfig, step: int, host_index: int = 0, host_count: int = 1,
                  device="cuda"):
    """``(tokens, labels)``, int32 ``(global_batch // host_count, seq_len)``
    each, for this host's rows of the global batch at ``step``, on
    ``device``."""
    if cfg.global_batch % host_count:
        raise ValueError(f"global batch {cfg.global_batch} does not split over "
                         f"{host_count} hosts")
    local = cfg.global_batch // host_count
    n = cfg.seq_len + 1
    raw = torch.multinomial(_zipf_probs(cfg), local * n, replacement=True,
                            generator=_generator(cfg, step, host_index))
    raw = raw.reshape(local, n).to(torch.int32)
    mix = torch.roll(raw, 1, dims=1) * 31 % cfg.vocab_size
    use_mix = (torch.arange(n) % 3) == 0
    toks = torch.where(use_mix[None, :], mix, raw)
    toks[:, ::cfg.bos_period] = 1  # BOS
    toks = toks.to(as_device(device))
    return toks[:, :-1], toks[:, 1:]


class DataIterator:
    """Stateless-resumable iterator over :func:`batch_at_step`."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, host_index: int = 0,
                 host_count: int = 1, device="cuda"):
        self.cfg = cfg
        self.step = start_step
        self.host_index = host_index
        self.host_count = host_count
        self.device = device

    def __iter__(self):
        return self

    def __next__(self):
        b = batch_at_step(self.cfg, self.step, self.host_index, self.host_count, self.device)
        self.step += 1
        return b
