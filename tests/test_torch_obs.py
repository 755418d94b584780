"""``repro_torch.obs`` held against the JAX package's ``repro.obs`` on the CPU:
the tracer, the spans and counters at their sites, the schedule-IR
timelines, the partitioned schedule, the drift auditor and the instrumented
backends.

Every test leaves **both** packages' tracers disabled and empty: each tracer
is process-global state, and a leaked enable would wrap every backend that
later test modules in the same worker construct.
"""
import dataclasses
import importlib
import json
import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi
from repro import backends as jbackends
from repro import obs as jobs
from repro.core import schedule as jschedule
from repro.core.perf_model import MTTKRPWorkload as JMTTKRPWorkload
from repro.core.psram import PsramConfig as JPsramConfig
from repro.sparse import partition as jpartition
from repro.sparse import stream as jstream
from repro.sparse import synth as jsynth
from repro_torch import api, backends, convert, obs
from repro_torch.core import cp_als as t_cp
from repro_torch.core import schedule
from repro_torch.core.perf_model import MeshSparseMTTKRPWorkload, MTTKRPWorkload
from repro_torch.core.psram import PsramConfig
from repro_torch.obs import drift as tdrift
from repro_torch.obs.instrument import InstrumentedBackend
from repro_torch.sparse import csf_for_mode, partition
from repro_torch.sparse import stream as tstream

j_cp = importlib.import_module("repro.core.cp_als")   # the module, not the function

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPE = (40, 30, 20)


@pytest.fixture(autouse=True)
def _clean_tracers():
    for o in (obs, jobs):
        o.disable()
        o.get_tracer().clear()
    yield
    for o in (obs, jobs):
        o.disable()
        o.get_tracer().clear()


def _enable_both():
    for o in (obs, jobs):
        o.enable()


def _scalar(v):
    """A JAX or numpy scalar as the Python scalar it holds."""
    if isinstance(v, (jax.Array, np.generic)):
        return v.item()
    return v


def _spans(o):
    """``(name, args)`` of every ``X`` event, args as Python scalars."""
    return [(e["name"], {k: _scalar(v) for k, v in e.get("args", {}).items()})
            for e in o.get_tracer().events() if e["ph"] == "X"]


def _counters(o):
    return {k: _scalar(v) for k, v in o.get_tracer().counters().items()}


@pytest.fixture(scope="module")
def coo_pair():
    """A power-law COO, 40 x 30 x 20 with 500 samples, in both packages."""
    ref = jsynth.powerlaw_coo(jax.random.PRNGKey(0), SHAPE, nnz=500, rank=4, alpha=1.1)
    port = convert.coo(np.asarray(ref.indices), np.asarray(ref.values), SHAPE, device="cpu")
    return ref, port


# ------------------------------------------------------------------ tracer


def test_span_records_events_and_counters():
    obs.enable()
    with obs.span("test/outer", k=3):
        with obs.span("test/inner"):
            pass
        obs.counter("test/widgets", 2.0)
        obs.counter("test/widgets", 1.0)
    events = obs.get_tracer().events()
    names = [e["name"] for e in events]
    assert names == ["test/inner", "test/outer"]  # closed in LIFO order
    outer = events[1]
    assert outer["ph"] == "X" and outer["cat"] == "test"
    assert outer["args"] == {"k": 3}
    assert outer["dur"] >= events[0]["dur"]       # outer spans the inner
    assert obs.get_tracer().counters()["test/widgets"] == pytest.approx(3.0)


def test_summary_aggregates_per_name():
    obs.enable()
    for _ in range(3):
        with obs.span("test/unit"):
            pass
    s = obs.summary()
    assert s["test/unit"]["count"] == 3
    assert s["test/unit"]["total_s"] >= s["test/unit"]["max_s"]


def test_chrome_trace_is_valid_json(tmp_path):
    obs.enable()
    with obs.span("test/one"):
        pass
    obs.counter("test/n", 5)
    path = tmp_path / "trace.json"
    n = obs.write_trace(str(path))
    trace = json.loads(path.read_text())
    assert len(trace["traceEvents"]) == n
    phases = {e["ph"] for e in trace["traceEvents"]}
    assert {"M", "X", "C"} <= phases              # meta + spans + counters
    assert trace["otherData"] == {"producer": "repro_torch.obs"}


def test_chrome_trace_layout_equals_the_reference():
    """The same spans and counters give the same trace layout: event keys,
    metadata, the counter samples, ``displayTimeUnit``; only the producer
    and the clock readings differ."""
    _enable_both()
    for o in (obs, jobs):
        with o.span("test/outer", k=3):
            with o.span("test/inner"):
                pass
        o.counter("test/n", 5)
    port, ref = obs.get_tracer().to_chrome_trace(), jobs.get_tracer().to_chrome_trace()
    assert port["displayTimeUnit"] == ref["displayTimeUnit"]
    assert ref["otherData"]["producer"] == "repro.obs"
    assert port["otherData"]["producer"] == "repro_torch.obs"

    def timeless(ev):
        return {k: (v if k not in ("ts", "dur", "tid") else None) for k, v in ev.items()}

    assert [timeless(e) for e in port["traceEvents"]] == \
        [timeless(e) for e in ref["traceEvents"]]


def test_disabled_tracer_is_null_and_cheap():
    """Disabled spans are one shared no-op object — no clock reads, no
    allocation per call — and the per-iteration overhead of a disabled
    span stays under 5 µs."""
    assert not obs.enabled()
    assert obs.span("test/x") is obs.span("test/y", a=1)   # shared singleton
    obs.counter("test/never")                               # no-op
    assert obs.get_tracer().events() == []
    assert obs.get_tracer().counters() == {}

    n = 20_000

    def plain():
        acc = 0
        for i in range(n):
            acc += i
        return acc

    def spanned():
        acc = 0
        for i in range(n):
            with obs.span("test/hot"):
                acc += i
        return acc

    assert plain() == spanned()
    t_plain = min(_once(plain) for _ in range(3))
    t_span = min(_once(spanned) for _ in range(3))
    per_iter_overhead = max(0.0, t_span - t_plain) / n
    assert per_iter_overhead < 5e-6, (
        f"disabled span costs {per_iter_overhead * 1e6:.2f}us/iter")
    assert obs.get_tracer().events() == []        # still nothing recorded


def _once(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def test_stopwatch_measures_even_when_disabled():
    assert not obs.enabled()
    with obs.stopwatch("test/sw") as sw:
        pass
    assert sw.duration_s >= 0.0
    assert obs.get_tracer().events() == []        # measured, not recorded
    obs.enable()
    with obs.stopwatch("test/sw") as sw:
        pass
    assert sw.duration_s >= 0.0
    assert [e["name"] for e in obs.get_tracer().events()] == ["test/sw"]


def test_traced_cpu_run_leaves_cuda_uninitialized():
    """Tracing enabled from the environment, a traced CPU ``cp_als`` and a
    stopwatch: the tracer never initializes CUDA (it waits for the card only
    where the process already uses it)."""
    code = (
        "import torch\n"
        "from repro_torch import obs\n"
        "from repro_torch.core.cp_als import cp_als\n"
        "from repro_torch.sparse import powerlaw_coo\n"
        "assert obs.enabled()\n"
        "coo = powerlaw_coo(0, (12, 10, 8), nnz=200, rank=3, device='cpu')\n"
        "with obs.stopwatch('test/sw'):\n"
        "    cp_als(None, 3, n_iter=2, sparse=coo, backend='psram-stream', tol=0)\n"
        "names = {e['name'] for e in obs.get_tracer().events()}\n"
        "assert {'als/sweep', 'als/fit', 'backend/psram-stream/mttkrp',\n"
        "        'stream/mttkrp/execute', 'test/sw'} <= names, names\n"
        "print('CUDA_INITIALIZED', torch.cuda.is_initialized())\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "REPRO_TORCH_TRACE": "1"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=str(ROOT), env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "CUDA_INITIALIZED False" in proc.stdout


# ------------------------------------------------- spans and counters, sites


@pytest.mark.parametrize("backend", ["psram-stream", "exact"])
def test_cp_als_spans_and_counters_equal_the_reference(coo_pair, backend):
    """``cp_als`` on the sparse tensor, 2 sweeps at rank 4: the sequence of
    ``(name, args)`` of the spans (``backend/<name>/*``, ``als/sweep``,
    ``als/fit``, ``stream/mttkrp/execute``) and the counters are the
    reference's."""
    ref, port = coo_pair
    _enable_both()
    j_cp.cp_als(None, 4, n_iter=2, sparse=ref, backend=backend, tol=0)
    t_cp.cp_als(None, 4, n_iter=2, sparse=port, backend=backend, tol=0)
    got, want = _spans(obs), _spans(jobs)
    assert got == want
    names = [n for n, _ in got]
    assert names.count("als/sweep") == 2 and names.count("als/fit") == 2
    assert f"backend/{backend}/mttkrp" in names
    assert _counters(obs) == _counters(jobs)
    json.dumps(obs.get_tracer().to_chrome_trace())


@pytest.mark.parametrize("compiled", [False, True], ids=["eager", "compiled"])
def test_stream_mttkrp_span_equals_the_reference(coo_pair, compiled):
    """``stream_mttkrp`` on each mode, eager and compiled, at a small
    ``exec_blocks``: the span's args (``exec_blocks`` as the reference's
    executor steps) and the counters are the reference's."""
    ref, port = coo_pair
    rng = np.random.default_rng(3)
    fs = [rng.standard_normal((s, 5)).astype(np.float32) for s in SHAPE]
    jcfg, tcfg = JPsramConfig(rows=16), PsramConfig(rows=16)
    _enable_both()
    from repro.sparse import csf_for_mode as j_csf_for_mode

    for mode in range(3):
        jstream.stream_mttkrp(j_csf_for_mode(ref, mode), tuple(jnp.asarray(f) for f in fs),
                              jcfg, compiled=compiled, exec_blocks=3)
        tstream.stream_mttkrp(csf_for_mode(port, mode), tuple(torch.tensor(f) for f in fs),
                              tcfg, compiled=compiled, exec_blocks=3)
    assert _spans(obs) == _spans(jobs)
    assert _counters(obs) == _counters(jobs)


def test_api_matmul_and_execute_reference_spans_equal_the_reference():
    """``api.matmul`` on ``psram-scheduled`` (the backend span around
    ``schedule/execute/matmul``) and ``execute_reference`` on a small
    program: spans, args and counters equal to the reference's."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((9, 40)).astype(np.float32)
    w = rng.standard_normal((40, 11)).astype(np.float32)
    geometry = dict(rows=16, word_cols=8, wavelengths=4)
    jcfg, tcfg = JPsramConfig(**geometry), PsramConfig(**geometry)
    _enable_both()
    japi.matmul(jnp.asarray(x), jnp.asarray(w), backend="psram-scheduled", config=jcfg)
    api.matmul(torch.tensor(x), torch.tensor(w), backend="psram-scheduled", config=tcfg)
    jschedule.execute_reference(jschedule.build_matmul_program(9, 40, 11, jcfg),
                                jnp.asarray(x), jnp.asarray(w))
    schedule.execute_reference(schedule.build_matmul_program(9, 40, 11, tcfg),
                               torch.tensor(x), torch.tensor(w))
    got = _spans(obs)
    assert got == _spans(jobs)
    assert [n for n, _ in got] == ["schedule/execute/matmul", "backend/psram-scheduled/matmul",
                                   "schedule/execute/reference"]
    assert _counters(obs) == _counters(jobs)
    assert obs.get_tracer().counters()["schedule/programs_executed"] == 1.0


# ---------------------------------------------------------- virtual timeline


def _program_pairs():
    jcfg, tcfg = JPsramConfig(), PsramConfig()
    fibers = [(13 * i) % 97 + 1 for i in range(300)]
    return {
        "matmul": (jschedule.build_matmul_program(128, 300, 40, jcfg),
                   schedule.build_matmul_program(128, 300, 40, tcfg), 100_000),
        "stream": (jstream.build_stream_program(np.asarray(fibers), 16, jcfg),
                   tstream.build_stream_program(np.asarray(fibers), 16, tcfg), 100_000),
        "coalesced": (jschedule.build_matmul_program(512, 1024, 512, jcfg),
                      schedule.build_matmul_program(512, 1024, 512, tcfg), 200),
        "repeats": (jschedule.build_mttkrp_program(jcfg, JMTTKRPWorkload(i=2048, j=256, k=64,
                                                                         rank=32)),
                    schedule.build_mttkrp_program(tcfg, MTTKRPWorkload(i=2048, j=256, k=64,
                                                                       rank=32)), 500),
    }


@pytest.mark.parametrize("case", ["matmul", "stream", "coalesced", "repeats"])
def test_program_timeline_equals_the_reference(case):
    jprog, tprog, max_events = _program_pairs()[case]
    if case == "repeats":
        assert tprog.repeats > 1
    got = obs.program_timeline(tprog, pid=7, name="unit", max_events=max_events)
    want = jobs.program_timeline(jprog, pid=7, name="unit", max_events=max_events)
    assert got == want
    xs = [e for e in got if e["ph"] == "X"]
    if case == "coalesced":
        assert any("ops" in e["args"] for e in xs)
    window = schedule.count_cycles(tprog).total_cycles
    assert max(e["ts"] + e["dur"] for e in xs) <= window
    json.dumps(got)


def test_mesh_timeline_equals_the_reference():
    """Four arrays of a skewed fiber list: the events (pids from each
    tracer's allocator, cleared alike) equal the reference's; the fabric's
    all-reduce starts at the slowest array's counted cycles."""
    fibers = tuple((13 * i) % 97 + 1 for i in range(64))
    got = obs.mesh_timeline(fibers, 16, config=PsramConfig(), n_arrays=4)
    want = jobs.mesh_timeline(fibers, 16, config=JPsramConfig(), n_arrays=4)
    assert got == want
    ps = partition.partition_fiber_lengths(fibers, 4, 16, PsramConfig(), planner="makespan")
    reduce_ev = [e for e in got if e["ph"] == "X" and e["name"] == "allreduce"]
    assert len(reduce_ev) == 1 and reduce_ev[0]["ts"] == ps.critical_path_cycles


@pytest.mark.parametrize("planner", ["nnz", "makespan"])
@pytest.mark.parametrize("n_arrays", [1, 3, 4])
def test_partition_fiber_lengths_equals_the_reference(planner, n_arrays):
    fibers = np.asarray([(37 * i) % 613 + 1 for i in range(1, 97)] + [5000, 1, 1])
    got = partition.partition_fiber_lengths(fibers, n_arrays, 16, PsramConfig(),
                                            planner=planner)
    want = jpartition.partition_fiber_lengths(fibers, n_arrays, 16, JPsramConfig(),
                                              planner=planner)
    assert [dataclasses.asdict(p) for p in got.partitions] == \
        [dataclasses.asdict(p) for p in want.partitions]
    assert len(got.programs) == len(want.programs) == n_arrays
    for a, b in zip(got.programs, want.programs):
        assert [dataclasses.asdict(op) for op in a.ops] == [dataclasses.asdict(op) for op in b.ops]
        assert (a.repeats, a.shape) == (b.repeats, b.shape)
    assert dataclasses.asdict(got.counts) == dataclasses.asdict(want.counts)
    assert got.critical_path_cycles == want.critical_path_cycles
    assert got.imbalance == want.imbalance


# ------------------------------------------------------------ drift auditor


def test_drift_rows_equal_the_reference():
    """The port's default set, the reference's four workloads: five rows
    (the dense operating point on two counted backends), each equal field
    for field to the reference's row of the same workload and backend, and
    no drift."""
    report = obs.drift_report()
    assert len(report.rows) == 5
    assert report.max_drift == 0.0
    want = {(r.workload, r.backend): r.to_dict() for r in jobs.drift_report().rows}
    for row in report.rows:
        assert row.to_dict() == {k: _scalar(v) for k, v in
                                 want[(row.workload, row.backend)].items()}
    assert len(report.table().strip().splitlines()) == len(report.rows) + 3
    json.dumps(report.to_json())


def test_drift_cli_exit_codes(tmp_path, capsys):
    out = tmp_path / "drift.json"
    assert tdrift.main(["--json", str(out), "--fail-on-drift"]) == 0
    assert json.loads(out.read_text())["max_drift"] == 0.0
    capsys.readouterr()


def test_drift_cli_module_runs():
    proc = subprocess.run([sys.executable, "-m", "repro_torch.obs.drift", "--fail-on-drift"],
                          capture_output=True, text=True, timeout=120, cwd=str(ROOT),
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "max analytical-vs-counted drift: 0.000e+00" in proc.stdout


def test_drift_mesh_workload_raises_pointed_error():
    """A mesh workload no longer raises: it audits on ``"psram-mesh"``, one
    row equal to the reference's, no drift."""
    fibers = tuple((37 * i) % 613 + 1 for i in range(1, 65))
    report = obs.drift_report({"mttkrp/sparse/mesh4":
                               MeshSparseMTTKRPWorkload(fiber_lengths=fibers, n_arrays=4)})
    want = jobs.drift_report({"mttkrp/sparse/mesh4": _reference_mesh_workload(fibers)})
    assert [r.backend for r in report.rows] == ["psram-mesh"]
    assert report.max_drift == 0.0
    assert report.rows[0].to_dict() == {k: _scalar(v) for k, v in want.rows[0].to_dict().items()}


def _reference_mesh_workload(fibers):
    """The reference's 4-array mesh workload of ``fibers``."""
    from repro.core.perf_model import MeshSparseMTTKRPWorkload as JMesh

    return JMesh(fiber_lengths=fibers, n_arrays=4)


# ---------------------------------------------------------- instrumentation


def test_registry_wraps_backends_only_when_enabled():
    be = backends.get("exact")
    assert not isinstance(be, InstrumentedBackend)
    obs.enable()
    be = backends.get("exact")
    assert isinstance(be, InstrumentedBackend)
    # instances pass through unwrapped — and instrumented ones re-enter
    assert backends.get(be) is be
    inner = be.inner
    assert backends.get(inner) is inner
    assert be.name == inner.name and be.config is inner.config
    assert be.capabilities() == inner.capabilities()


def _executable_backends():
    return [n for n in backends.list_backends()
            if backends.get(n).capabilities().executes]


@pytest.mark.parametrize("name", ["exact", "psram-oracle", "psram-scheduled", "psram-stream",
                                  "hopper", "psram-mesh"])
def test_instrumented_backend_is_transparent(coo_pair, name):
    """Each executable backend registered: wrapped and unwrapped give the
    same bits on the CPU for every protocol call its capabilities allow,
    and each wrapped call records its ``backend/<name>/<op>`` span."""
    assert name in _executable_backends()
    _, port = coo_pair
    raw = backends.get(name)
    obs.enable()
    be = backends.get(name)
    assert isinstance(be, InstrumentedBackend) and be.inner is not raw
    caps = be.capabilities()
    rng = np.random.default_rng(1)
    fs = tuple(torch.tensor(rng.standard_normal((s, 4)).astype(np.float32)) for s in SHAPE)
    ops = ["gram"]
    assert torch.equal(be.gram(fs[0]), raw.gram(fs[0]))
    if caps.matmul:
        x = torch.tensor(rng.standard_normal((8, 16)).astype(np.float32))
        w = torch.tensor(rng.standard_normal((16, 4)).astype(np.float32))
        assert torch.equal(be.matmul(x, w), raw.matmul(x, w))
        ops.append("matmul")
    if caps.sparse:
        for mode in range(3):
            csf = csf_for_mode(port, mode)
            assert torch.equal(be.mttkrp(csf, fs, mode), raw.mttkrp(csf, fs, mode))
        ops.append("mttkrp")
    names = {n for n, _ in _spans(obs)}
    assert {f"backend/{name}/{op}" for op in ops} <= names
    if caps.matmul:
        args = next(a for n, a in _spans(obs) if n == f"backend/{name}/matmul")
        assert args == {"m": 8, "k": 16, "n": 4}


def test_instrumented_cost_span_equals_the_reference():
    _enable_both()
    est = backends.get("analytical").cost(MTTKRPWorkload())
    ref = jbackends.get("analytical").cost(JMTTKRPWorkload())
    assert est.sustained_petaops == ref.sustained_petaops
    assert _spans(obs) == _spans(jobs) == [("backend/analytical/cost",
                                            {"workload": "MTTKRPWorkload"})]


def test_write_trace_after_cp_als_is_valid_json(coo_pair, tmp_path):
    _, port = coo_pair
    obs.enable()
    t_cp.cp_als(None, 4, n_iter=2, sparse=port, backend="psram-stream", tol=0)
    path = tmp_path / "trace.json"
    n = obs.write_trace(str(path))
    trace = json.loads(path.read_text())
    assert len(trace["traceEvents"]) == n
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert all(e["cat"] == e["name"].split("/", 1)[0] for e in xs)
    counters = {e["name"]: e["args"]["value"] for e in trace["traceEvents"] if e["ph"] == "C"}
    # every sweep's three mode MTTKRPs and its exact fit stream the tensor
    streamed = [e["args"]["nnz"] for e in xs if e["name"] == "stream/mttkrp/execute"]
    assert len(streamed) == 2 * 4
    assert counters["stream/nonzeros"] == sum(streamed)
