"""The tracer: nestable spans + typed counters, exported as Chrome
``trace_event`` JSON.

One process-global :class:`Tracer` instance backs the module-level front
doors in :mod:`repro_torch.obs` (``span`` / ``stopwatch`` / ``counter``).
The design constraints, in order:

* **zero-cost when disabled** — ``span()`` is a flag check plus the return
  of one shared no-op context manager; no clock is read, no object
  allocated, no lock taken, no device touched (tests/test_torch_obs.py
  holds a disabled span under 5 µs).
* **device-true timing when asked** — CUDA launches return before the card
  has done the work, so a host clock alone around them measures the
  enqueue. A :class:`Stopwatch` (always timing) and a recording span
  (tracing enabled) therefore wait for the card's queued work on entry and
  on exit (``torch.cuda.synchronize()`` of the current device): the span
  covers the device work launched inside it and none queued before it.
  That costs the overlap of host and card across the span's edges — the
  price of a true number; with tracing disabled no span waits.
  Three exceptions: a process that has not initialized CUDA has nothing
  queued, and the tracer never initializes it (a CPU-only run never touches
  the card); and a span entered or left while the current stream captures a
  CUDA graph does not synchronize (a synchronize would abort the capture) —
  it records the host's time only and says so in its args
  (``"capturing": true``).
* **thread-safe, thread-aware** — events carry the recording thread as
  their Chrome ``tid``; nesting within a thread renders as stacked slices
  in Perfetto (``X`` events nest by ts/dur).

Span args and counter values are the caller's plain Python ``int`` /
``float`` / ``str`` / ``bool`` (the call sites convert numpy and tensor
scalars), so ``write_trace`` serializes them as they are.

Enabling: ``REPRO_TORCH_TRACE`` in the environment (any value but
``0``/empty) enables tracing at import; ``enable()`` / ``disable()`` toggle
it programmatically at any point.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any

import torch

ENV_VAR = "REPRO_TORCH_TRACE"

# wall-clock spans record under this Chrome pid; virtual (cycle-domain)
# timelines allocate their own pids via next_pid() so the two domains sit
# in separate process groups in Perfetto
WALL_PID = 0


def _wait_for_device() -> bool:
    """Wait until the current CUDA device has done every queued launch.

    Returns False, without waiting, while the current stream captures a
    graph (a synchronize there aborts the capture). A process that has not
    initialized CUDA has queued nothing and is left untouched."""
    if not torch.cuda.is_initialized():
        return True
    if torch.cuda.is_current_stream_capturing():
        return False
    torch.cuda.synchronize()
    return True


class _NullSpan:
    """The shared no-op context manager returned when tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Stopwatch:
    """A span that always times, and records only when tracing is on.

    ``duration_s`` is valid after ``__exit__``: the device work launched
    inside the block included (see the module docstring). :meth:`elapsed_s`
    reads the host clock alone, without waiting for the card. The measured
    number is the caller's to keep — the one mechanism that owns wall-clock
    measurement for the serve launcher and the autotuner.
    """

    __slots__ = ("tracer", "name", "args", "t0", "duration_s")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.t0 = 0.0
        self.duration_s = 0.0

    def __enter__(self) -> "Stopwatch":
        if not _wait_for_device():
            self.args["capturing"] = True
        self.t0 = time.perf_counter()
        return self

    def elapsed_s(self) -> float:
        return time.perf_counter() - self.t0

    def __exit__(self, *exc):
        if not _wait_for_device():
            self.args["capturing"] = True
        self.duration_s = time.perf_counter() - self.t0
        if self.tracer.enabled:
            self.tracer._record(self.name, self.t0, self.duration_s,
                                self.args)
        return False


class _Span(Stopwatch):
    """A recording span (only constructed when tracing is enabled)."""

    __slots__ = ()


class Tracer:
    """Collects spans and counters; renders Chrome ``trace_event`` JSON."""

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._counters: dict[str, float] = {}
        self._epoch = time.perf_counter()
        self._next_pid = 1

    # -- recording ---------------------------------------------------------

    def span(self, name: str, **args: Any):
        """A nestable span context manager — the shared no-op when tracing
        is disabled (the zero-cost contract), a recording span otherwise."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    def stopwatch(self, name: str, **args: Any) -> Stopwatch:
        """A span that ALWAYS measures (``duration_s`` after exit) and
        records the event only when tracing is enabled."""
        return Stopwatch(self, name, args)

    def counter(self, name: str, value: float = 1.0) -> None:
        """Accumulate a named counter (no-op when disabled). Integer values
        stay integers; floats stay floats — ``counters()`` returns whatever
        type accumulated."""
        if not self.enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def _record(self, name: str, t0: float, dur_s: float, args: dict):
        ev = {
            "name": name,
            "ph": "X",
            "pid": WALL_PID,
            "tid": threading.get_ident() & 0xFFFF,
            "ts": (t0 - self._epoch) * 1e6,
            "dur": dur_s * 1e6,
            "cat": name.split("/", 1)[0],
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def add_events(self, events: list[dict]) -> None:
        """Inject pre-built trace events (the virtual timelines of
        :mod:`repro_torch.obs.timeline`) regardless of the enabled flag —
        callers emitting a timeline have already opted in."""
        with self._lock:
            self._events.extend(events)

    def next_pid(self) -> int:
        """Allocate a fresh Chrome pid for a virtual-timeline process."""
        with self._lock:
            pid = self._next_pid
            self._next_pid += 1
            return pid

    # -- reading out -------------------------------------------------------

    def counters(self) -> dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def summary(self) -> dict[str, dict]:
        """Per-span-name aggregates: ``{name: {count, total_s, max_s}}`` —
        what printed summaries source instead of their own timers."""
        out: dict[str, dict] = {}
        for ev in self.events():
            if ev.get("ph") != "X":
                continue
            s = out.setdefault(ev["name"],
                               {"count": 0, "total_s": 0.0, "max_s": 0.0})
            dur = ev["dur"] / 1e6
            s["count"] += 1
            s["total_s"] += dur
            s["max_s"] = max(s["max_s"], dur)
        return out

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._counters.clear()
            self._epoch = time.perf_counter()
            self._next_pid = 1

    def to_chrome_trace(self) -> dict:
        """The full trace as a Chrome ``trace_event`` object — wall-clock
        spans (pid 0) plus any injected virtual timelines, with process
        metadata and final counter values, loadable in Perfetto /
        ``chrome://tracing``."""
        events = self.events()
        meta = [{
            "name": "process_name", "ph": "M", "pid": WALL_PID,
            "args": {"name": "wall-clock (us)"},
        }]
        counters = self.counters()
        if counters:
            # one terminal counter sample per name, on the wall-clock track
            ts = max((e["ts"] + e.get("dur", 0) for e in events
                      if e.get("pid") == WALL_PID), default=0.0)
            for cname, val in sorted(counters.items()):
                meta.append({
                    "name": cname, "ph": "C", "pid": WALL_PID, "ts": ts,
                    "args": {"value": val},
                })
        return {"traceEvents": meta + events,
                "displayTimeUnit": "ms",
                "otherData": {"producer": "repro_torch.obs"}}

    def write_trace(self, path: str) -> int:
        """Write :meth:`to_chrome_trace` as JSON; returns the event count."""
        trace = self.to_chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
        return len(trace["traceEvents"])


_TRACER = Tracer()
if os.environ.get(ENV_VAR, "") not in ("", "0"):
    _TRACER.enabled = True


def get_tracer() -> Tracer:
    return _TRACER


def enable() -> None:
    _TRACER.enabled = True


def disable() -> None:
    _TRACER.enabled = False


def enabled() -> bool:
    return _TRACER.enabled


def span(name: str, **args):
    return _TRACER.span(name, **args)


def stopwatch(name: str, **args) -> Stopwatch:
    return _TRACER.stopwatch(name, **args)


def counter(name: str, value: float = 1.0) -> None:
    _TRACER.counter(name, value)
