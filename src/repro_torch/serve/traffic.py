"""Synthetic serving traffic: seeded arrivals + heavy-tail request sizes.

The live loop (`repro_torch.serve.loop`) is only as meaningful as the request
stream driving it — a serving claim measured under uniform arrivals and
uniform lengths is a benchmark of nothing. This generator produces the two
shapes production traces actually have:

* **arrivals** — Poisson (exponential inter-arrival at ``rate_rps``) or
  *bursty*: a two-phase Markov-modulated Poisson process alternating an
  on-phase at ``rate_rps * burst_factor`` with an idle phase at
  ``rate_rps / burst_factor``, phase lengths exponential around
  ``burst_len_s`` / ``idle_len_s``. Bursts are what exercise the admission
  queue and force preemptions; a plain Poisson stream at the same mean rate
  rarely does.
* **lengths** — bounded Pareto (Lomax) prompt and decode lengths:
  ``lo * (1 + Pareto(alpha))`` clipped to ``[lo, hi]``. Smaller ``alpha`` =
  heavier tail. Most requests are short, a few are near ``hi`` — the mix
  that makes continuous batching (join/leave between steps) matter.

Everything is driven by one ``numpy`` ``default_rng(seed)`` — no wall-clock
seeding anywhere, so a (seed, config) pair replays the identical stream:
the same one as the reference package's ``repro.serve.traffic``, draw for
draw. A run records both (:meth:`TrafficConfig.asdict`).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Knobs of one synthetic request stream (all lengths in tokens)."""

    n_requests: int = 100
    seed: int = 0
    arrival: str = "poisson"      # "poisson" | "bursty"
    rate_rps: float = 50.0        # mean arrival rate, requests/second
    burst_factor: float = 8.0     # on-phase rate multiplier (bursty only)
    burst_len_s: float = 0.2      # mean on-phase length
    idle_len_s: float = 0.6       # mean idle-phase length
    prompt_min: int = 4
    prompt_max: int = 96
    prompt_tail: float = 1.8      # Pareto alpha; smaller = heavier tail
    decode_min: int = 2
    decode_max: int = 64
    decode_tail: float = 1.5
    vocab_size: int = 256         # prompt token ids drawn from [2, vocab)

    def asdict(self) -> dict:
        """JSON-ready view, from which a run can be replayed."""
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Request:
    """One request: token ids + how many tokens to decode."""

    rid: int
    arrival_s: float
    prompt: np.ndarray            # (prompt_len,) int32
    decode_len: int

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


def _bounded_pareto(rng: np.random.Generator, n: int, lo: int, hi: int,
                    alpha: float) -> np.ndarray:
    """``lo * (1 + Lomax(alpha))`` clipped to [lo, hi], as int."""
    if lo > hi:
        raise ValueError(f"lo={lo} > hi={hi}")
    draw = lo * (1.0 + rng.pareto(alpha, size=n))
    return np.clip(draw.astype(np.int64), lo, hi)


def _poisson_arrivals(rng: np.random.Generator, n: int,
                      rate: float) -> np.ndarray:
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def _bursty_arrivals(rng: np.random.Generator, n: int, rate: float,
                     burst_factor: float, burst_len_s: float,
                     idle_len_s: float) -> np.ndarray:
    """Two-phase MMPP: exponential phase lengths, Poisson within a phase."""
    out: list[float] = []
    t = 0.0
    on = True
    while len(out) < n:
        phase_len = rng.exponential(burst_len_s if on else idle_len_s)
        phase_rate = rate * (burst_factor if on else 1.0 / burst_factor)
        end = t + phase_len
        while len(out) < n:
            t += rng.exponential(1.0 / phase_rate)
            if t > end:
                t = end
                break
            out.append(t)
        on = not on
    return np.asarray(out)


def generate(cfg: TrafficConfig) -> list[Request]:
    """The request stream for ``cfg`` — deterministic in (seed, config)."""
    if cfg.arrival not in ("poisson", "bursty"):
        raise ValueError(
            f"unknown arrival process {cfg.arrival!r}; "
            "pick 'poisson' or 'bursty'")
    if cfg.rate_rps <= 0:
        raise ValueError("rate_rps must be positive")
    rng = np.random.default_rng(cfg.seed)
    if cfg.arrival == "poisson":
        arrivals = _poisson_arrivals(rng, cfg.n_requests, cfg.rate_rps)
    else:
        arrivals = _bursty_arrivals(
            rng, cfg.n_requests, cfg.rate_rps, cfg.burst_factor,
            cfg.burst_len_s, cfg.idle_len_s)
    prompt_lens = _bounded_pareto(
        rng, cfg.n_requests, cfg.prompt_min, cfg.prompt_max, cfg.prompt_tail)
    decode_lens = _bounded_pareto(
        rng, cfg.n_requests, cfg.decode_min, cfg.decode_max, cfg.decode_tail)
    reqs = []
    for i in range(cfg.n_requests):
        prompt = rng.integers(
            2, cfg.vocab_size, size=int(prompt_lens[i])).astype(np.int32)
        reqs.append(Request(
            rid=i, arrival_s=float(arrivals[i]), prompt=prompt,
            decode_len=int(decode_lens[i])))
    return reqs
