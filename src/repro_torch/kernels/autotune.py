"""Tile parameters for the fused kernel family — the deterministic heuristic.

The streaming MTTKRP has one free knob, the chunk size (``exec_blocks``
blocks per chunk), and it is *numerics*: the ADC digitizes each chunk over
its own observed range. The untuned default here equals the reference
package's, so both packages cut the same chunks.

Ported: :class:`TuneKey`, :func:`nnz_profile`, :func:`heuristic`,
:func:`stream_key`, and :func:`stream_params` returning the heuristic only.
Still to come from the reference module: the candidate sweeps (timed with
CUDA events), the winner cache and ``save_cache`` / ``load_cache``.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.psram import PsramConfig


@dataclasses.dataclass(frozen=True)
class TuneKey:
    """What a tuned winner is keyed by: the kernel kind, the workload shape,
    its nonzero profile (empty for dense), and the array config — all
    hashable by value, so equal-by-value keys share one entry."""

    kind: str                 # "stream" | "matmul" | "dense_mttkrp"
    shape: tuple              # workload dims (+ rank where it matters)
    profile: tuple            # bucketed nnz statistics; () for dense
    config: PsramConfig


def nnz_profile(nnz: int, fiber_lengths=None) -> tuple:
    """Bucketed nonzero profile: (log2-nnz bucket, log2-mean-fiber bucket).

    Buckets rather than raw counts so workloads of the same scale and
    fiber irregularity share one tuned entry."""
    nnz_bucket = int(math.log2(max(1, int(nnz))))
    if fiber_lengths is None or len(fiber_lengths) == 0:
        return (nnz_bucket,)
    mean_fiber = float(nnz) / max(1, len(fiber_lengths))
    return (nnz_bucket, int(math.log2(max(1.0, mean_fiber))))


def heuristic(key: TuneKey) -> dict:
    """The deterministic no-tuning default per kind — what an untuned run
    executes."""
    if key.kind == "stream":
        # ~8Ki nonzeros per chunk
        return {"exec_blocks": max(1, 8192 // key.config.rows)}
    if key.kind == "matmul":
        return {"bm": 128, "bn": 128, "bk": 512}
    if key.kind == "dense_mttkrp":
        return {"bi": 128, "bk": 128}
    raise ValueError(f"unknown tune kind {key.kind!r}")


def stream_key(csf, rank: int, config: PsramConfig) -> TuneKey:
    return TuneKey(
        kind="stream",
        shape=tuple(csf.shape) + (rank,),
        profile=nnz_profile(csf.nnz, csf.fiber_lengths()),
        config=config,
    )


def stream_params(csf, factors, config: PsramConfig, tune: bool = False) -> dict:
    """``{"exec_blocks": n}`` for one streaming workload: the heuristic.
    ``tune=True`` (sweep and cache a winner) is not ported yet."""
    if tune:
        raise NotImplementedError(
            "autotune sweeps are not ported yet (ROADMAP Queue A item 2); "
            "run with the deterministic heuristic")
    return heuristic(stream_key(csf, int(factors[0].shape[-1]), config))
