"""Cycle-accurate virtual timelines from the schedule IR.

A :class:`~repro_torch.core.schedule.TileProgram` already carries the exact
cycle cost of every op — ``count_cycles`` collapses them to scalars; this
module unrolls them onto a clock instead. The result is a list of Chrome
``trace_event`` dicts (the same format the wall-clock tracer emits) that
renders the photonic schedule as tracks in Perfetto / ``chrome://tracing``:

* one **store** track (``StoreTile`` ops, ``rows_written`` cycles each), and
* one track per **WDM channel** showing when that channel carries light —
  a ``Drive`` occupies channels ``0..channels-1`` for ``cycles`` cycles; a
  ``GatherDrive`` serving ``segments`` output-row segments round-robins them
  over the channels, so channel ``c`` is busy ``⌈(segments - c) / W⌉``
  of the op's cycles.

The virtual clock maps **1 array cycle → 1 trace microsecond**, so at the
paper's 20 GHz the rendered timeline is wall time × 20 000. Virtual
timelines live in their own Chrome process (a ``pid`` from the tracer's
allocator), keeping the cycle domain visually separate from the wall-clock
span domain; the process name records the cycle→µs convention.

Real programs can be huge (a 3.4M-nnz stream is ~27k ops across 52
channels); ``max_events`` bounds the output by coalescing runs of
consecutive slices per track into aggregate slices once the exact rendering
would exceed the budget — aggregates carry ``ops``/``cycles`` args so no
cycles silently disappear. A ``repeats > 1`` accounting program renders its
first window exactly and the remaining repeats as one aggregate slice per
track spanning the rest of the virtual time.

Pure Python over the IR: nothing here touches a tensor or the card.
"""
from __future__ import annotations

from repro_torch.core.schedule import Drive, GatherDrive, StoreTile, TileProgram

from . import tracer as _tracer

STORE_TID = 0  # channel c renders on tid c + 1


def _track_slices(program: TileProgram) -> tuple[dict, int]:
    """One walk of ``program.ops`` (a single repeat) into per-track slice
    lists ``{tid: [(ts, dur, name, args), ...]}`` plus the window length in
    cycles. The cursor is serial — the array is one resource; stores and
    drives never overlap (§III-B: a write cycle is not a compute cycle)."""
    tracks: dict[int, list] = {STORE_TID: []}
    wav = program.config.wavelengths
    t = 0
    for op in program.ops:
        if isinstance(op, StoreTile):
            tracks[STORE_TID].append(
                (t, op.rows_written, "store",
                 {"rows": op.rows_written, "live_words": op.live_words}))
            t += op.rows_written
        elif isinstance(op, Drive):
            for c in range(op.channels):
                tracks.setdefault(c + 1, []).append(
                    (t, op.cycles, "drive",
                     {"live_words": op.live_words}))
            t += op.cycles
        elif isinstance(op, GatherDrive):
            nch = min(op.segments, wav)
            for c in range(nch):
                # round-robin: channel c serves segments c, c+W, c+2W, ...
                busy = (op.segments - c - 1) // wav + 1
                tracks.setdefault(c + 1, []).append(
                    (t, busy, "gather",
                     {"segments": (op.segments - c - 1) // wav + 1}))
            t += op.cycles
        else:
            raise TypeError(f"unknown op {op!r}")
    return tracks, t


def _coalesce(slices: list, group: int) -> list:
    """Merge runs of ``group`` consecutive slices into aggregate slices
    spanning first-start → last-end, summing busy cycles into args."""
    out = []
    for i in range(0, len(slices), group):
        run = slices[i:i + group]
        if len(run) == 1:
            out.append(run[0])
            continue
        ts = run[0][0]
        end = max(s[0] + s[1] for s in run)
        busy = sum(s[1] for s in run)
        out.append((ts, end - ts, f"{run[0][2]} x{len(run)}",
                    {"ops": len(run), "busy_cycles": busy}))
    return out


def program_timeline(
    program: TileProgram,
    pid: int | None = None,
    name: str = "schedule-IR",
    max_events: int = 100_000,
) -> list[dict]:
    """Render one program's schedule as Chrome trace events (see module
    docstring for the track layout and the cycle→µs clock). ``pid`` defaults
    to a fresh virtual process from the tracer's allocator; pass an explicit
    one to place several programs (mesh shards) deterministically."""
    if pid is None:
        pid = _tracer.get_tracer().next_pid()
    tracks, window = _track_slices(program)
    n_slices = sum(len(v) for v in tracks.values())
    # repeats: first window exact, the rest one aggregate slice per track
    extra = program.repeats - 1
    budget = max(len(tracks) + 1, max_events - (len(tracks) if extra else 0))
    if n_slices > budget:
        group = -(-n_slices // budget)
        tracks = {tid: _coalesce(v, group) for tid, v in tracks.items()}

    events: list[dict] = [{
        "name": "process_name", "ph": "M", "pid": pid,
        "args": {"name": f"{name} (1 cycle = 1 us)"},
    }]
    for tid in sorted(tracks):
        label = "store" if tid == STORE_TID else f"ch{tid - 1:02d}"
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": label}})
        events.append({"name": "thread_sort_index", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"sort_index": tid}})
    for tid, slices in tracks.items():
        for ts, dur, sname, args in slices:
            events.append({"name": sname, "ph": "X", "cat": "virtual",
                           "pid": pid, "tid": tid, "ts": float(ts),
                           "dur": float(dur), "args": args})
        if extra and slices:
            busy = sum(s[1] for s in slices)
            events.append({
                "name": f"x{extra} more windows", "ph": "X",
                "cat": "virtual", "pid": pid, "tid": tid,
                "ts": float(window), "dur": float(window * extra),
                "args": {"repeats": extra, "busy_cycles_per_window": busy},
            })
    return events


def mesh_timeline(
    fiber_lengths,
    rank: int,
    config=None,
    n_arrays: int = 1,
    planner: str = "makespan",
    fabric=None,
    out_rows: int | None = None,
    max_events: int = 100_000,
    schedule=None,
) -> list[dict]:
    """The mesh-sharded streaming schedule as one virtual process per array
    plus a reduction-fabric process: each planned partition's stream program
    renders via :func:`program_timeline`, and the fabric track carries the
    all-reduce starting at the makespan (arrays run concurrently; the
    reduction waits for the slowest — exactly how ``MeshPrice`` prices it).
    It needs the fiber lengths alone, so it renders a mesh schedule before
    (or without) a run. ``schedule`` is a plan already made for these fiber
    lengths (a ``sparse.partition.PartitionedSchedule``, such as the
    ``MeshedSparseTensor`` a mesh run executed: what
    ``sparse.mesh.mesh_plan_timeline`` hands in) to render instead of
    planning anew.
    """
    import numpy as np

    from repro_torch.backends.base import resolve_config
    from repro_torch.core.perf_model import allreduce_cycles
    from repro_torch.core.schedule import count_cycles
    from repro_torch.sparse.partition import partition_fiber_lengths

    cfg = resolve_config(config)
    f = np.asarray(fiber_lengths, dtype=np.int64)
    ps = schedule
    if ps is None:
        ps = partition_fiber_lengths(f, n_arrays, rank, cfg, planner=planner)
    elif len(ps.programs) != n_arrays:
        raise ValueError(f"the schedule holds {len(ps.programs)} arrays, not {n_arrays}")
    tr = _tracer.get_tracer()
    per_budget = max(64, max_events // max(1, len(ps.programs) + 1))
    events: list[dict] = []
    makespan = 0
    for a, prog in enumerate(ps.programs):
        events.extend(program_timeline(
            prog, pid=tr.next_pid(), name=f"array{a:02d}",
            max_events=per_budget))
        makespan = max(makespan, count_cycles(prog).total_cycles)
    reduced = int((f > 0).sum()) if out_rows is None else int(out_rows)
    reduce_cycles = allreduce_cycles(reduced, rank, n_arrays, fabric)
    fabric_pid = tr.next_pid()
    events.append({"name": "process_name", "ph": "M", "pid": fabric_pid,
                   "args": {"name": "reduce fabric (1 cycle = 1 us)"}})
    events.append({"name": "allreduce", "ph": "X", "cat": "virtual",
                   "pid": fabric_pid, "tid": 0, "ts": float(makespan),
                   "dur": float(max(1, reduce_cycles)),
                   "args": {"reduce_cycles": reduce_cycles,
                            "n_arrays": n_arrays, "rows": reduced,
                            "rank": rank}})
    return events
