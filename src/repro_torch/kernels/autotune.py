"""Tile autotuner for the fused kernel family.

The fused executors have one free knob each that the reference sweeps — the
chunk size (``exec_blocks``) for the streaming MTTKRP, tile shapes for the
dense kernels. This module sweeps a small candidate set, times each
in-process (median of repeats on the real operands, every trial through
``repro_torch.obs.stopwatch``, which waits for the card at both edges), and
caches the winner per :class:`TuneKey`: keys are frozen dataclasses compared
*by value*, so two equal-by-value ``(shape, nnz-profile, PsramConfig)`` keys
share one tuned entry.

``exec_blocks`` is **numerics**, not only speed: the ADC digitizes each
chunk over its own observed range, so a tuned run differs from the untuned
one within the fused family's envelope (one ADC code of the chunk's full
scale per partial). The reference sweeps it all the same, and so does the
port; on the card a candidate whose chunk does not fit the ``"chunk"``
route's shared memory runs on ``"three_pass"``, and each trial's route is
kept in :func:`sweep_log`.

Untuned runs never move: when tuning is off (the default, or
``REPRO_TORCH_AUTOTUNE=0`` — the port's own switch, so one variable never
switches both packages in one process) :func:`get_params` returns the
deterministic heuristic — the same parameters as the reference's — without
touching the cache. Winners can be shipped: :func:`save_cache` /
:func:`load_cache` round-trip the table through JSON with the reference's
key tokens (``dataclasses.asdict`` of both packages' ``PsramConfig``
serializes alike), so a table either package saves, the other loads.

The spans are the reference's: ``autotune/sweep`` (kind, shape,
candidates) around a sweep, ``autotune/trial/run`` (kind and the
candidate's params) around each timed repeat, ``autotune/winner`` (kind,
shape, median_s and the winner's params), and the counter
``autotune/trials``. The whole reference module is ported.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import warnings

from repro_torch import obs
from repro_torch.core.psram import PsramConfig

ENV_VAR = "REPRO_TORCH_AUTOTUNE"


@dataclasses.dataclass(frozen=True)
class TuneKey:
    """What a tuned winner is keyed by: the kernel kind, the workload shape,
    its nonzero profile (empty for dense), and the array config — all
    hashable by value, so equal-by-value keys share one entry."""

    kind: str                 # "stream" | "matmul" | "dense_mttkrp"
    shape: tuple              # workload dims (+ rank where it matters)
    profile: tuple            # bucketed nnz statistics; () for dense
    config: PsramConfig


_WINNERS: dict[TuneKey, dict] = {}
_SWEEPS: list[dict] = []


def enabled(requested: bool = True) -> bool:
    """Is tuning live? ``REPRO_TORCH_AUTOTUNE=0`` force-disables it (the
    determinism escape hatch) — the heuristic default is used instead."""
    return bool(requested) and os.environ.get(ENV_VAR, "1") != "0"


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
    executes, and the first candidate of every sweep."""
    if key.kind == "stream":
        # ~8Ki nonzeros per chunk
        return {"exec_blocks": max(1, 8192 // key.config.rows)}
    if key.kind == "matmul":
        return {"bm": 128, "bn": 128, "bk": 512}
    if key.kind == "dense_mttkrp":
        return {"bi": 128, "bk": 128}
    raise ValueError(f"unknown tune kind {key.kind!r}")


def candidates(key: TuneKey) -> list[dict]:
    """The sweep set per kind (heuristic first, so ties keep the default)."""
    if key.kind == "stream":
        rows = key.config.rows
        ebs = {max(1, nnz // rows) for nnz in (4096, 8192, 16384, 32768, 65536)}
        base = heuristic(key)["exec_blocks"]
        return [{"exec_blocks": eb}
                for eb in sorted(ebs, key=lambda e: (e != base, e))]
    if key.kind == "matmul":
        return [heuristic(key)] + [
            {"bm": bm, "bn": bn, "bk": bk}
            for bm, bn, bk in ((128, 128, 128), (128, 128, 256),
                               (256, 256, 512), (64, 64, 512))
        ]
    if key.kind == "dense_mttkrp":
        return [heuristic(key)] + [
            {"bi": bi, "bk": bk}
            for bi, bk in ((64, 128), (128, 256), (256, 128), (64, 64))
        ]
    raise ValueError(f"unknown tune kind {key.kind!r}")


def _median_time(fn, repeats: int = 3, name: str = "autotune/trial/run",
                 **meta) -> float:
    """Median seconds of ``fn`` over ``repeats``, after one warm-up call
    outside the clock — each repeat through the ``obs`` stopwatch, which
    waits for the card before and after, so the launches' device time is
    inside it; every repeat lands in the trace (the candidate's params as
    span args) whenever tracing is on."""
    fn()
    times = []
    for _ in range(repeats):
        with obs.stopwatch(name, **meta) as sw:
            fn()
        times.append(sw.duration_s)
    times.sort()
    return times[len(times) // 2]


def get_params(key: TuneKey, measure=None, tune: bool = False,
               repeats: int = 3) -> dict:
    """The parameters to run ``key`` with.

    Cached winner if one exists (tuned earlier or loaded); otherwise, when
    ``tune`` is live and a ``measure`` factory is given, sweep
    :func:`candidates` — ``measure(params)`` returns a nullary runner over
    the real operands (an ``info`` dict attribute on it goes into
    :func:`sweep_log` beside the trial) — and cache the fastest. Else: the
    deterministic :func:`heuristic` (NOT cached, so a later tuned run still
    happens).
    """
    hit = _WINNERS.get(key) or _check_loaded(key)
    if hit is not None:
        return hit
    if not enabled(tune) or measure is None:
        return heuristic(key)
    best, best_t = None, float("inf")
    trials = []
    with obs.span("autotune/sweep", kind=key.kind, shape=str(key.shape),
                  candidates=len(candidates(key))):
        for params in candidates(key):
            run = measure(params)
            t = _median_time(run, repeats=repeats,
                             name="autotune/trial/run", kind=key.kind,
                             **params)
            trials.append({"params": dict(params), "median_s": t,
                           **getattr(run, "info", {})})
            if obs.enabled():
                obs.counter("autotune/trials")
            if t < best_t:
                best, best_t = params, t
    if obs.enabled():
        with obs.span("autotune/winner", kind=key.kind, shape=str(key.shape),
                      median_s=best_t, **best):
            pass
    _WINNERS[key] = best
    _SWEEPS.append({"key": key, "trials": trials, "winner": dict(best)})
    return best


def sweep_log() -> tuple[dict, ...]:
    """Every sweep this process ran since the cache was last cleared, in
    order: ``{"key", "trials": [{"params", "median_s", ...}], "winner"}``
    (a stream trial on the card also names its kernel route)."""
    return tuple(_SWEEPS)


# ------------------------------------------------------- per-kind front doors


def stream_key(csf, rank: int, config: PsramConfig) -> TuneKey:
    return TuneKey(
        kind="stream",
        shape=tuple(csf.shape) + (rank,),
        profile=nnz_profile(csf.nnz, csf.fiber_lengths()),
        config=config,
    )


def stream_params(csf, factors, config: PsramConfig, tune: bool = False,
                  adc_bits: int = 16, lowering: str = "auto") -> dict:
    """Winner/heuristic ``{"exec_blocks": n}`` for one streaming workload.

    When tuning, each candidate runs the port's fused executor on the real
    layout (``sparse.stream.stream_layout``) and the stored quantized
    factors (``stream_factor_quants``) — on CUDA tensors kernel 1 over the
    layout's :class:`~repro_torch.kernels.stream_mttkrp.SegmentPlan`, on the
    CPU its plain version — median of 3 after a warm-up call. The last
    candidate's layout stays cached on the CSF; the caller's run at the
    winner builds its own where it differs. ``lowering`` follows
    ``backends.lowering`` (``"auto"``: the tensors' device).
    """
    key = stream_key(csf, int(factors[0].shape[-1]), config)
    if key in _WINNERS or not enabled(tune):
        return get_params(key)

    from repro_torch.backends.lowering import require_cuda, resolve_lowering
    from repro_torch.sparse.stream import stream_layout

    from .stream_mttkrp import (_LOWERING_FNS, plan_route, segment_plan,
                                stream_factor_quants)

    factors = tuple(factors)
    low = resolve_lowering(lowering, csf.values, *factors)
    mode = csf.mode_order[0]
    out_rows = csf.shape[mode]
    qs, ss = stream_factor_quants(factors, mode)
    fn = _LOWERING_FNS[low]

    def measure(params):
        ip, vp, lp, sp, n_seg = stream_layout(csf, config.rows, params["exec_blocks"])
        require_cuda(low, ip)
        if low != "cuda":
            def run():
                return fn(ip, vp, lp, sp, qs, ss, mode, n_seg, adc_bits, out_rows)
            run.info = {"route": low}
            return run
        plan = segment_plan(csf, config.rows, lp, sp, n_seg)

        def run():
            return fn(ip, vp, lp, sp, qs, ss, mode, n_seg, adc_bits, out_rows, plan=plan)
        run.info = {"route": plan_route(qs, mode, plan)}
        return run

    return get_params(key, measure=measure, tune=True)


def matmul_key(m: int, k: int, n: int, config: PsramConfig) -> TuneKey:
    return TuneKey(kind="matmul", shape=(m, k, n), profile=(), config=config)


def dense_mttkrp_key(i: int, j: int, k: int, rank: int,
                     config: PsramConfig) -> TuneKey:
    return TuneKey(kind="dense_mttkrp", shape=(i, j, k, rank), profile=(),
                   config=config)


# ----------------------------------------------------------- cache plumbing


def cache_stats() -> tuple[int, tuple[TuneKey, ...]]:
    """(#winners, keys) — introspection for tests and benches."""
    return len(_WINNERS), tuple(_WINNERS)


def clear_autotune_cache() -> None:
    """Drop the tuned and loaded winners and the sweep log (tests; called by
    ``core.schedule.clear_program_cache``). The port has no compiled
    executor per winner to drop: the layouts and segment plans a winner
    selects are cached on its CSF."""
    _WINNERS.clear()
    _LOADED.clear()
    _SWEEPS.clear()


def _key_token(key: TuneKey) -> str:
    return json.dumps(
        [key.kind, list(key.shape), list(key.profile),
         dataclasses.asdict(key.config)],
        sort_keys=True)


def save_cache(path: str) -> int:
    """Write the winner table as JSON (canonical string keys); returns the
    number of entries written. Ship it with a deployment and
    :func:`load_cache` at startup to run pre-tuned."""
    with open(path, "w") as f:
        json.dump({_key_token(k): v for k, v in _WINNERS.items()}, f,
                  indent=2, sort_keys=True)
    return len(_WINNERS)


def load_cache(path: str) -> int:
    """Merge a saved winner table. Entries are matched lazily by token:
    a loaded winner is installed for a live :class:`TuneKey` the first time
    :func:`get_params` asks for it. Returns the number of entries loaded.

    A corrupt or truncated cache file is a warning, not an error: tuned
    winners are an optimization, so a damaged table must never take the
    deployment down — the heuristic defaults stay in force and 0 is
    returned. A missing file still raises (a wrong path is a caller bug).
    """
    with open(path) as f:
        try:
            loaded = json.load(f)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            warnings.warn(
                f"autotune cache {path!r} is corrupt ({e}); ignoring it — "
                "heuristic defaults stay in force", stacklevel=2)
            return 0
    if not isinstance(loaded, dict):
        warnings.warn(
            f"autotune cache {path!r} holds {type(loaded).__name__}, not a "
            "winner table; ignoring it", stacklevel=2)
        return 0
    good = {k: v for k, v in loaded.items()
            if isinstance(k, str) and isinstance(v, dict)}
    if len(good) != len(loaded):
        warnings.warn(
            f"autotune cache {path!r}: dropped {len(loaded) - len(good)} "
            "malformed entries", stacklevel=2)
    _LOADED.update(good)
    return len(good)


_LOADED: dict[str, dict] = {}


def _check_loaded(key: TuneKey) -> dict | None:
    params = _LOADED.get(_key_token(key))
    if params is not None:
        _WINNERS[key] = params
    return params
