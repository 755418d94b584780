"""repro_torch.obs — tracing, metrics, and cycle-accurate virtual timelines.

One observability layer for every execution path: spans and counters
(:mod:`~repro_torch.obs.tracer`), schedule-IR virtual timelines in the
cycle domain (:mod:`~repro_torch.obs.timeline`), the registry-level backend
wrapper (:mod:`~repro_torch.obs.instrument`), and the estimate-vs-measured
drift auditor (:mod:`~repro_torch.obs.drift`). Everything exports Chrome
``trace_event`` JSON — one file, loadable in Perfetto / ``chrome://tracing``,
with the wall-clock process next to one virtual process per array schedule.

Usage::

    from repro_torch import obs

    obs.enable()                              # or REPRO_TORCH_TRACE=1
    with obs.span("stream/mttkrp/execute", nnz=12345):
        ...
    obs.counter("stream/nonzeros", 12345)
    obs.write_trace("trace.json")

    sw = obs.stopwatch("serve/generate")      # times even when disabled
    with sw:
        ...
    print(sw.duration_s)

    print(obs.drift_report().table())         # estimate vs measured

What a span measures: on the card, the device work launched inside it —
a recording span and every stopwatch wait for the card's queued work
(``torch.cuda.synchronize()``) on entry and on exit, so the host's clock
reads the card's time; inside a CUDA graph capture they do not wait and
record the host's time with ``"capturing": true``. On the CPU, the host's
time, which is the work's. A process that never initialized CUDA is never
made to.

Span-naming convention — ``layer/component/detail``, slash-separated, three
levels, lowercase:

* **layer** — the subsystem: ``backend``, ``schedule``, ``stream``,
  ``mesh``, ``autotune``, ``fault``, ``als``, ``serve``, ``train``, ``obs``
  (the reference's ``bench`` layer comes with the module that emits it).
* **component** — the object or phase within it: a backend name
  (``backend/psram-stream/...``), an executor (``schedule/execute``), a
  loop phase (``als/sweep``).
* **detail** — the operation or instance: ``mttkrp``, ``matmul``,
  ``gram``, ``cost``, an iteration tag.

Two levels are fine when there is no meaningful third (``als/fit``,
``serve/generate``); the first segment doubles as the Chrome ``cat`` field,
so Perfetto can filter by layer. Metadata goes in span **args** (keyword
arguments to ``span``/``stopwatch``, plain Python scalars and strings), not
in the name — names should aggregate across calls, args should vary.

The spans and counters the port emits today, at the reference's sites:

* ``backend/<name>/{mttkrp,matmul,gram,cost}`` — every backend
  ``backends.get`` constructs while tracing is enabled
  (:class:`~repro_torch.obs.instrument.InstrumentedBackend`);
* ``als/sweep`` (iteration, backend, rank) and ``als/fit`` (iteration,
  exact) — ``core.cp_als.cp_als``;
* ``stream/mttkrp/execute`` (nnz, mode, compiled, psram, exec_blocks) and
  the counters ``stream/nonzeros``, ``stream/blocks`` —
  ``sparse.stream.stream_mttkrp``;
* ``schedule/execute/matmul`` (m, k, n, compiled) with the counter
  ``schedule/programs_executed``, and ``schedule/execute/reference`` (m, k,
  n, ops) with ``schedule/reference_ops`` — ``core.schedule``;
* ``serve/generate`` (batch, max_new, arch) — the stopwatch of
  ``launch.serve``;
* ``train/step`` (step) — the stopwatch of ``train.Trainer``;
* ``obs/drift/report`` (workloads) — :func:`drift_report`.

* ``autotune/sweep`` (kind, shape, candidates), ``autotune/trial/run``
  (kind and the candidate's params), ``autotune/winner`` (kind, shape,
  median_s and the params) and the counter ``autotune/trials`` —
  ``kernels.autotune``;
* ``mesh/shard{i}/plan`` (nnz) with the counter ``mesh/shard{i}/nnz``, and
  ``mesh/stream/execute`` (nnz, n_arrays, lowering, planner, mode) —
  ``sparse.mesh.mesh_stream_mttkrp``; ``fault/mesh/shard_values`` (arrays,
  dead) with ``fault/arrays_lost`` while a plan is armed, and
  ``fault/inject/armed`` with ``fault/injected`` — ``faults.plan``;
  ``fault/abft/{check,redrive,fallback}`` (kind and the site) with the
  counters ``fault/detected``, ``fault/redrives``, ``fault/recovered`` and
  ``fault/recovery_cycles`` — ``faults.abft``; ``fault/mesh/degraded``
  (dead, n_arrays) and ``fault/mesh/redrive`` (array, nnz, rows) with
  ``fault/arrays_lost`` and ``fault/recovered_rows`` — ``faults.degraded``.

The paged serve loop: ``serve/admit`` (queued), ``serve/offload``
(batch), ``serve/evict`` (rid), ``serve/fail`` (rid, reason) and the
stopwatches ``serve/prefill`` (rid, prompt) and ``serve/decode`` (batch,
view), with the counters ``serve/admitted``, ``serve/rejected``,
``serve/preempted``, ``serve/prefills``, ``serve/decode_steps``,
``serve/tokens`` and ``serve/failed`` — ``serve.loop``.

The tracer is zero-cost when disabled: ``span()`` returns a shared no-op
context manager without reading a clock or touching the card (overhead
held in tests/test_torch_obs.py). ``stopwatch()`` always measures and
exposes ``duration_s`` — it records an event only when tracing is enabled,
so hot paths that need the number pay one synchronized clock pair either
way.
"""
from __future__ import annotations

from .tracer import (
    Stopwatch,
    Tracer,
    counter,
    disable,
    enable,
    enabled,
    get_tracer,
    span,
    stopwatch,
)

__all__ = [
    "Stopwatch",
    "Tracer",
    "counter",
    "disable",
    "drift_report",
    "enable",
    "enabled",
    "get_tracer",
    "mesh_timeline",
    "program_timeline",
    "span",
    "stopwatch",
    "summary",
    "write_trace",
]


def write_trace(path: str) -> int:
    """Write the global tracer's Chrome trace JSON; returns event count."""
    return get_tracer().write_trace(path)


def summary() -> dict:
    """Per-span-name aggregates of the global tracer."""
    return get_tracer().summary()


def program_timeline(program, pid=None, name="schedule-IR",
                     max_events=100_000):
    """Lazy front door of :func:`repro_torch.obs.timeline.program_timeline`."""
    from .timeline import program_timeline as impl

    return impl(program, pid=pid, name=name, max_events=max_events)


def mesh_timeline(fiber_lengths, rank, config=None, n_arrays=1,
                  planner="makespan", fabric=None, out_rows=None,
                  max_events=100_000, schedule=None):
    """Lazy front door of :func:`repro_torch.obs.timeline.mesh_timeline`."""
    from .timeline import mesh_timeline as impl

    return impl(fiber_lengths, rank, config=config, n_arrays=n_arrays,
                planner=planner, fabric=fabric, out_rows=out_rows,
                max_events=max_events, schedule=schedule)


def drift_report(workloads=None, config=None, wall_times=None):
    """Lazy front door of :func:`repro_torch.obs.drift.drift_report`."""
    from .drift import drift_report as impl

    return impl(workloads=workloads, config=config, wall_times=wall_times)
