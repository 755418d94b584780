"""The mesh-sharded streaming MTTKRP of the port (``repro_torch.sparse.mesh``,
the ``"psram-mesh"`` backend, ``launch.mesh``) held against the JAX
package's ``repro.sparse.mesh`` on the CPU.

Three contracts, in increasing scope:

* **Planning + pricing** (pure accounting): the plans equal the reference's,
  the makespan planner never loses to the nnz cut it starts from, empty
  shards are first-class and price zero cycles, and the analytical mesh
  price equals the counted mesh schedule *exactly*, equal to the
  reference's, at every array count on the paper's §V-A operating point.
* **Execution against the reference**: every lowering against the
  reference's one-device ``mesh_stream_mttkrp``; the eager lowering
  bit-equal to the reference's single-device ``stream_mttkrp(psram=True)``
  run op by op (``jax.disable_jit()``); an armed ``ArrayLoss`` +
  ``AdcSpike`` plan giving the reference's result; the ``mesh/*`` spans and
  the ``mesh4`` drift row equal to the reference's.
* **Many arrays in this process**: what the reference checks in an
  8-device subprocess runs here on one CPU device — arrays share a device
  in the port — the eager stream bit-equal at 1, 2, 4 and 8 arrays and in
  reversed array order, ``"fused"`` at 8 arrays, the split Gram, and the
  CP-ALS fit through ``"psram-mesh"`` (8 arrays) against ``"psram-stream"``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import backends as jbackends
from repro import faults as jfaults
from repro import obs as jobs
from repro.core import mttkrp as jm
from repro.core.perf_model import MeshSparseMTTKRPWorkload as JMeshWorkload
from repro.faults import plan as jplan
from repro.sparse import csf_for_mode as j_csf_for_mode
from repro.sparse import mesh as jmesh
from repro.sparse import partition as jpartition
from repro.sparse import powerlaw_coo as j_powerlaw_coo
from repro.sparse import powerlaw_fiber_lengths as j_powerlaw_fiber_lengths
from repro.sparse import stream as jstream
from repro_torch import backends, convert, faults, obs
from repro_torch.core.cp_als import cp_als
from repro_torch.core.perf_model import (
    DEFAULT_FABRIC,
    MeshFabric,
    MeshSparseMTTKRPWorkload,
    allreduce_cycles,
    mesh_sparse_price,
    stream_counts,
)
from repro_torch.launch import mesh as lmesh
from repro_torch.launch.mesh import ArrayMesh, chips, make_array_mesh
from repro_torch.sparse import (
    MESH_LOWERINGS,
    PLANNERS,
    csf_for_mode,
    mesh_counted_price,
    mesh_gram,
    mesh_stream_mttkrp,
    partition_csf,
    partition_fiber_lengths,
    plan_partitions,
    resolve_array_mesh,
    stream_mttkrp,
)
from repro_torch.sparse import mesh as tmesh

SHAPE, RANK = (40, 30, 20), 16


@pytest.fixture(autouse=True)
def _clean_tracers():
    for o in (obs, jobs):
        o.disable()
        o.get_tracer().clear()
    yield
    for o in (obs, jobs):
        o.disable()
        o.get_tracer().clear()


@pytest.fixture(scope="module")
def cfg():
    return backends.resolve_config(None)  # paper §V-A operating point


@pytest.fixture(scope="module")
def fibers():
    return j_powerlaw_fiber_lengths(1, n_rows=500, nnz=20000)


@pytest.fixture(scope="module")
def pair():
    """The reference's test tensor (its 8-device script's), carried to the
    port, with numpy-seeded factors; and the reference's single-device
    ``stream_mttkrp(psram=True)`` of mode 0 run op by op (~3 s, once)."""
    key = jax.random.PRNGKey(0)
    jcoo = j_powerlaw_coo(key, SHAPE, nnz=2000)
    rng = np.random.default_rng(0)
    fs = [rng.standard_normal((s, RANK)).astype(np.float32) for s in SHAPE]
    tcoo = convert.coo(np.asarray(jcoo.indices), np.asarray(jcoo.values), SHAPE,
                       mode_order=jcoo.mode_order, device="cpu")
    jcsf = j_csf_for_mode(jcoo, 0)
    jfs = tuple(jnp.asarray(f) for f in fs)
    with jax.disable_jit():
        ref = np.asarray(jstream.stream_mttkrp(jcsf, jfs, psram=True))
    return dict(jcoo=jcoo, jcsf=jcsf, jfs=jfs, tcoo=tcoo, tcsf=csf_for_mode(tcoo, 0),
                tfs=tuple(torch.tensor(f) for f in fs), ref=ref)


def _one_code(out, adc_bits=16):
    """One ADC code of full scale: ``2^(1 - adc_bits) · max|out|``."""
    return 2.0 ** (1 - adc_bits) * float(np.abs(out).max())


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


# ---------------------------------------------------------------- planning


def _makespan(cfg, f, parts, rank):
    return max(stream_counts(cfg, f[p.fiber_start:p.fiber_stop], rank)
               .total_cycles for p in parts)


def test_planner_front_door_equals_the_reference(cfg, fibers):
    with pytest.raises(ValueError, match="planner"):
        plan_partitions(fibers, 4, 32, cfg, planner="best-effort")
    assert set(PLANNERS) == {"nnz", "makespan"}
    for planner in PLANNERS:
        parts = plan_partitions(fibers, 4, 32, cfg, planner=planner)
        assert len(parts) == 4
        # contiguous cover of the fiber axis, monotone boundaries
        assert parts[0].fiber_start == 0
        assert parts[-1].fiber_stop == len(fibers)
        for a, b in zip(parts, parts[1:]):
            assert a.fiber_stop == b.fiber_start
        assert sum(p.nnz for p in parts) == int(fibers.sum())
        want = jpartition.plan_partitions(fibers, 4, 32, jbackends.resolve_config(None),
                                          planner=planner)
        assert [dataclasses.asdict(p) for p in parts] == [dataclasses.asdict(p) for p in want]


def test_makespan_planner_never_loses_to_nnz(cfg, fibers):
    for a in (2, 4, 8):
        nnz = plan_partitions(fibers, a, 32, cfg, planner="nnz")
        mk = plan_partitions(fibers, a, 32, cfg, planner="makespan")
        assert _makespan(cfg, fibers, mk, 32) <= _makespan(cfg, fibers, nnz, 32)


def test_empty_shards_are_first_class(cfg):
    # more arrays than fibers: graceful degradation, not a crash — the
    # surplus arrays get empty partitions priced at zero cycles
    tiny = np.array([5, 3, 2])
    for planner in PLANNERS:
        parts = plan_partitions(tiny, 8, 8, cfg, planner=planner)
        assert len(parts) == 8
        assert sum(p.nnz for p in parts) == 10
        empties = [p for p in parts if p.nnz == 0]
        assert empties, "8 arrays over 3 fibers must leave empty shards"
        for p in empties:
            assert p.fiber_start == p.fiber_stop
            assert stream_counts(cfg, tiny[p.fiber_start:p.fiber_stop], 8).total_cycles == 0
    price, ps = mesh_counted_price(tiny, 8, cfg, n_arrays=8)
    zero_priced = [c for c in price.per_array if c.total_cycles == 0]
    assert len(zero_priced) == len(empties)
    assert sum(c.total_cycles for c in price.per_array) > 0
    ps2 = partition_fiber_lengths(tiny, 8, 8, cfg, planner="makespan")
    assert len(ps2.programs) == 8


def test_empty_shards_execute_as_zeros_and_launch_nothing(monkeypatch):
    """Three root fibers on 8 arrays: five shards are empty. Each lowering
    runs only the three non-empty shards, the eager result is the
    single-device stream bit for bit, the others stay in their envelope."""
    rng = np.random.default_rng(3)
    idx = np.stack([np.repeat([2, 5, 9], [40, 25, 7]), rng.integers(0, 6, 72),
                    rng.integers(0, 7, 72)], 1).astype(np.int32)
    coo = convert.coo(idx, rng.standard_normal(72).astype(np.float32), (10, 6, 7),
                      device="cpu")
    csf = csf_for_mode(coo, 0)
    fs = tuple(torch.tensor(rng.standard_normal((s, 8)).astype(np.float32)) for s in (10, 6, 7))
    ran = []
    real = tmesh._run_shard
    monkeypatch.setattr(tmesh, "_run_shard", lambda shard, *a, **k: ran.append(shard.nnz)
                        or real(shard, *a, **k))
    ref = stream_mttkrp(csf, fs, psram=True)
    exact = backends.get("exact").mttkrp(coo, fs, 0)
    for lowering in MESH_LOWERINGS:
        ran.clear()
        got = mesh_stream_mttkrp(csf, fs, n_arrays=8, lowering=lowering)
        assert sorted(ran) == [7, 25, 40]
        if lowering == "eager":
            assert torch.equal(got, ref)
        assert _rel(got, exact) < 0.05
        assert bool((got[[0, 1, 3, 4, 6, 7, 8]] == 0).all())


# ----------------------------------------------------------------- pricing


def test_allreduce_closed_form():
    fab = MeshFabric(reduce_words=256)
    assert fab.allreduce_cycles(100, 32, 1) == 0          # single array
    assert fab.allreduce_cycles(0, 32, 8) == 0            # empty output
    # ceil(log2(8)) = 3 ring steps x ceil(100*32/256) words
    assert fab.allreduce_cycles(100, 32, 8) == 3 * -(-(100 * 32) // 256)
    assert allreduce_cycles(100, 32, 8) == DEFAULT_FABRIC.allreduce_cycles(100, 32, 8)


def test_analytical_matches_counted_exactly_and_the_reference(cfg, fibers):
    """``"analytical"`` equals counted per-array cycles + reduction steps
    *exactly* on the §V-A config, per array count, and both equal the
    reference's counted mesh price."""
    jcfg = jbackends.resolve_config(None)
    for a in (1, 2, 4, 8):
        wl = MeshSparseMTTKRPWorkload(fiber_lengths=fibers, rank=32, n_arrays=a)
        ana = mesh_sparse_price(cfg, wl)
        cnt, ps = mesh_counted_price(fibers, 32, cfg, n_arrays=a)
        assert ana.per_array == cnt.per_array          # field-for-field
        assert ana.makespan_cycles == cnt.makespan_cycles
        assert ana.reduce_cycles == cnt.reduce_cycles
        assert ana.counts == cnt.counts
        assert ana.duration_s(cfg) == cnt.duration_s(cfg)
        if a > 1:
            assert cnt.reduce_cycles > 0
        want, wps = jmesh.mesh_counted_price(fibers, 32, jcfg, n_arrays=a)
        assert [dataclasses.asdict(c) for c in cnt.per_array] \
            == [dataclasses.asdict(c) for c in want.per_array]
        assert (cnt.reduce_cycles, cnt.n_arrays, cnt.duration_s(cfg)) \
            == (want.reduce_cycles, want.n_arrays, want.duration_s(jcfg))
        assert [dataclasses.asdict(p) for p in ps.partitions] \
            == [dataclasses.asdict(p) for p in wps.partitions]
    wl = MeshSparseMTTKRPWorkload(fiber_lengths=fibers, rank=32, n_arrays=4)
    ana_est = backends.get("analytical", cfg).cost(wl)
    cnt_est = backends.get("psram-mesh", cfg).cost(wl)
    assert ana_est.time_s == cnt_est.time_s
    assert ana_est.counts == cnt_est.counts
    j_est = jbackends.get("psram-mesh", jcfg).cost(
        JMeshWorkload(fiber_lengths=tuple(fibers), rank=32, n_arrays=4))
    assert cnt_est.time_s == j_est.time_s
    assert dataclasses.asdict(cnt_est.counts) == dataclasses.asdict(j_est.counts)
    assert dataclasses.asdict(cnt_est.energy) == pytest.approx(dataclasses.asdict(j_est.energy))


def test_mesh_price_scales_down_makespan(cfg, fibers):
    times = []
    for a in (1, 2, 4, 8):
        price, _ = mesh_counted_price(fibers, 32, cfg, n_arrays=a)
        times.append(price.total_cycles)
    assert times[0] > times[1] > times[2] > times[3]


# ----------------------------------------------- single-device execution


def test_mesh_backend_registered():
    assert "psram-mesh" in backends.list_backends()
    for kw in ({}, {"compiled": True}, {"lowering": "fused"}, {"n_arrays": 4}):
        be = backends.get("psram-mesh", **kw)
        caps, want = be.capabilities(), jbackends.get("psram-mesh", **kw).capabilities()
        assert {k: v for k, v in dataclasses.asdict(caps).items() if k != "description"} \
            == {k: v for k, v in dataclasses.asdict(want).items() if k != "description"}
        assert be.lowering == jbackends.get("psram-mesh", **kw).lowering
    caps = backends.get("psram-mesh").capabilities()
    assert caps.executes and caps.cost_model and caps.sparse and not caps.matmul
    assert caps.lossy and caps.rel_tol == 0.05 and "sparse" in caps.prices
    assert caps.bit_exact            # eager default
    assert not backends.get("psram-mesh", lowering="fused").capabilities().bit_exact
    with pytest.raises(ValueError, match="lowering"):
        backends.get("psram-mesh", lowering="vectorized")
    with pytest.raises(backends.CapabilityError, match="psram-mesh"):
        backends.get("psram-mesh").cost(backends.MatmulWorkload(4, 4, 4))


def test_mesh_single_device_bitwise_vs_stream(pair):
    csf, fs = pair["tcsf"], pair["tfs"]
    ref = stream_mttkrp(csf, fs, psram=True)
    assert torch.equal(mesh_stream_mttkrp(csf, fs, n_arrays=1, lowering="eager"), ref)
    np.testing.assert_array_equal(ref.numpy(), pair["ref"])
    # through the registry, from raw COO (the backend sorts into a CSF itself)
    assert torch.equal(backends.get("psram-mesh").mttkrp(pair["tcoo"], fs, 0), ref)


@pytest.mark.parametrize("lowering", MESH_LOWERINGS)
def test_each_lowering_against_the_reference_one_device(pair, lowering):
    """Every mode at one array against the reference's one-device
    ``mesh_stream_mttkrp`` (jitted): the eager lowering within one ADC code
    (the jitted chain's reciprocal moves a code now and then), the compiled
    one within 1e-5 relative plus that code, the fused one within one code
    of each chunk's full scale per partial; each within 0.05 of exact."""
    for mode in range(3):
        jcsf, tcsf = j_csf_for_mode(pair["jcoo"], mode), csf_for_mode(pair["tcoo"], mode)
        want = np.asarray(jmesh.mesh_stream_mttkrp(jcsf, pair["jfs"], n_arrays=1,
                                                   lowering=lowering))
        got = mesh_stream_mttkrp(tcsf, pair["tfs"], n_arrays=1, lowering=lowering).numpy()
        scale = float(np.abs(want).max())
        if lowering == "eager":
            atol = _one_code(want)
        elif lowering == "compiled":
            atol = 1e-5 * scale + _one_code(want)
        else:                        # one chunk: one code of its full scale a partial
            atol = 2.0 ** -15 * scale * max(1, int(tcsf.fiber_lengths().max()) // 256 + 2)
        assert np.abs(got - want).max() <= atol, (mode, np.abs(got - want).max(), atol)
        exact = backends.get("exact").mttkrp(tcsf, pair["tfs"], mode)
        assert _rel(got, exact) < 0.05


def test_mesh_gram_matches_local(pair):
    for f in pair["tfs"]:
        assert torch.equal(mesh_gram(f, n_arrays=1), f.T @ f)
        for n in (2, 3, 8):
            np.testing.assert_allclose(mesh_gram(f, n_arrays=n).numpy(), (f.T @ f).numpy(),
                                       rtol=1e-5, atol=1e-5)
    f = pair["tfs"][0]
    assert torch.equal(backends.get("psram-stream").gram(f), f.T @ f)   # the local product
    np.testing.assert_allclose(backends.get("psram-mesh", n_arrays=4).gram(f).numpy(),
                               np.asarray(jmesh.mesh_gram(pair["jfs"][0], n_arrays=1)),
                               rtol=1e-5, atol=1e-5)


def test_make_array_mesh_validates():
    with pytest.raises(ValueError, match="at least one array"):
        make_array_mesh(0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_array_mesh(4)                  # the card by default: none here
        with pytest.raises(RuntimeError, match="CUDA"):
            make_array_mesh()
    mesh = make_array_mesh(device="cpu")
    assert mesh.axis_names == ("array",) and mesh.n_arrays == 1
    many = make_array_mesh(8, device="cpu")     # arrays share the one CPU
    assert many.n_arrays == 8 and chips(many) == 1
    assert {many.device_of(a) for a in range(8)} == {torch.device("cpu")}
    assert many.run_order() == tuple(range(8))
    assert ArrayMesh(4, ("cpu",), order=(3, 2, 1, 0)).run_order() == (3, 2, 1, 0)
    with pytest.raises(ValueError, match="permutation"):
        ArrayMesh(4, ("cpu",), order=(0, 1, 1, 2))
    with pytest.raises(ValueError, match="device"):
        ArrayMesh(2, ())
    assert lmesh.visible_devices("cpu") == (torch.device("cpu"),)
    assert resolve_array_mesh(many) is many
    assert resolve_array_mesh(None, 3, device="cpu").n_arrays == 3
    with pytest.raises(ValueError, match="disagrees"):
        resolve_array_mesh(many, 4)
    with pytest.raises(ValueError, match="ArrayMesh"):
        resolve_array_mesh(object())


def test_partition_csf_equals_the_reference(pair, cfg):
    """The shards of the CSF (fiber ranges, coordinates, values) and their
    programs, equal to the reference's at 1–8 arrays; ``mesh=`` gives the
    split ``n_arrays=`` gives at its array count."""
    jcfg = jbackends.resolve_config(None)
    for n in (1, 3, 8):
        for planner in PLANNERS:
            got = partition_csf(pair["tcsf"], n_arrays=n, rank=RANK, config=cfg, planner=planner)
            want = jpartition.partition_csf(pair["jcsf"], n_arrays=n, rank=RANK, config=jcfg,
                                            planner=planner)
            assert [dataclasses.asdict(p) for p in got.partitions] \
                == [dataclasses.asdict(p) for p in want.partitions]
            assert got.imbalance == want.imbalance
            assert got.critical_path_cycles == want.critical_path_cycles
            for a, b in zip(got.shards, want.shards):
                np.testing.assert_array_equal(a.expanded_indices_np(),
                                              np.asarray(b.expanded_indices()))
                np.testing.assert_array_equal(a.values.numpy(), np.asarray(b.values))
    for n in (1, 4):
        got = partition_csf(pair["tcsf"], mesh=make_array_mesh(n, device="cpu"), rank=RANK,
                            config=cfg)
        want = partition_csf(pair["tcsf"], n_arrays=n, rank=RANK, config=cfg)
        assert got.partitions == want.partitions and len(got.shards) == n
        for a, b in zip(got.shards, want.shards):
            assert torch.equal(a.values, b.values)
    with pytest.raises(ValueError, match="exactly one"):
        partition_csf(pair["tcsf"], rank=RANK)
    with pytest.raises(ValueError, match="rank"):
        partition_csf(pair["tcsf"], n_arrays=2)


# ----------------------------------------- many arrays, in this process


def test_eager_bit_equal_at_every_array_count_and_order(pair):
    """The eager sharded stream is the reference's single-device stream
    (op by op), bit for bit, whatever the array count and whatever order
    the arrays run and add in."""
    csf, fs, ref = pair["tcsf"], pair["tfs"], pair["ref"]
    for a in (1, 2, 4, 8):
        np.testing.assert_array_equal(
            mesh_stream_mttkrp(csf, fs, n_arrays=a, lowering="eager").numpy(), ref)
    rev = ArrayMesh(4, (torch.device("cpu"),), order=(3, 2, 1, 0))
    np.testing.assert_array_equal(mesh_stream_mttkrp(csf, fs, mesh=rev).numpy(), ref)
    # the shards' own psram chains: bit-equal to the reference's chain on them
    meshed = tmesh._mesh_partition(csf, 4, RANK, backends.resolve_config(None), "makespan")
    assert sum(s.nnz for s in meshed.shards) == csf.nnz


def test_fused_and_gram_at_eight_arrays(pair):
    got = mesh_stream_mttkrp(pair["tcsf"], pair["tfs"], n_arrays=8, lowering="fused")
    assert _rel(got, pair["ref"]) < 0.05
    compiled = mesh_stream_mttkrp(pair["tcsf"], pair["tfs"], n_arrays=8, lowering="compiled")
    assert _rel(compiled, pair["ref"]) < 1e-4
    f0 = pair["tfs"][0]
    np.testing.assert_allclose(mesh_gram(f0, n_arrays=8).numpy(), (f0.T @ f0).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_cp_als_fit_on_eight_arrays_matches_psram_stream(pair):
    csfs = [csf_for_mode(pair["tcoo"], m) for m in range(3)]
    init = [torch.tensor(np.random.default_rng(7).random((s, 8)).astype(np.float32))
            for s in SHAPE]
    fits = {}
    for name, kw in (("psram-stream", {}), ("psram-mesh", {"n_arrays": 8})):
        st = cp_als(None, 8, n_iter=8, backend=backends.get(name, **kw), sparse=pair["tcoo"],
                    csfs=csfs, init=init)
        fits[name] = float(st.fit)
    assert abs(fits["psram-stream"] - fits["psram-mesh"]) < 1e-3


# ----------------------------------------------------------------- faults


PLAN = faults.FaultPlan(seed=4, array_loss=(faults.ArrayLoss(1),),
                        adc_spikes=(faults.AdcSpike(rate=0.02, magnitude=0.5),))


def _jplan(plan):
    return jfaults.FaultPlan(
        seed=plan.seed, array_loss=tuple(jfaults.ArrayLoss(a.array_id) for a in plan.array_loss),
        adc_spikes=tuple(jfaults.AdcSpike(**dataclasses.asdict(s)) for s in plan.adc_spikes))


def test_armed_plan_gives_the_reference_result(pair):
    """4 arrays, array 1 lost and spikes on the survivors: the eager mesh
    equals the reference's pieces — its stacked eager layout
    (``_eager_shard_stack``) corrupted by its ``corrupt_shard_values``, each
    shard's quantized sparse MTTKRP op by op on its slice — bit for bit; the
    dead array's rows read zero; disarmed, the clean result comes back. At
    one array every lowering lands within the reference's one-device mesh
    under the same plan."""
    jcsf, tcsf, jfs, tfs = pair["jcsf"], pair["tcsf"], pair["jfs"], pair["tfs"]
    jcfg = jbackends.resolve_config(None)
    meshed = jmesh._mesh_partition(jcsf, 4, RANK, jcfg, "makespan")
    rows = jcfg.rows
    max_nnz = max(s.nnz for s in meshed.shards)
    eb = jstream._exec_blocks(rows, -(-max_nnz // rows), None)
    ip, rp, vp = jmesh._eager_shard_stack(meshed, SHAPE[0], rows * eb)
    with jfaults.inject(_jplan(PLAN)):
        vc = jplan.corrupt_shard_values(_jplan(PLAN), vp)
    want = np.zeros((SHAPE[0], RANK), np.float32)
    for a, s in enumerate(meshed.shards):
        if s.nnz:
            idx = np.asarray(s.expanded_indices())
            with jax.disable_jit():
                want += np.asarray(jm.mttkrp_sparse_psram(
                    jnp.asarray(idx), jnp.asarray(vc[a].reshape(-1)[:s.nnz]), jfs, 0, SHAPE[0]))
    with faults.inject(PLAN):
        got = mesh_stream_mttkrp(tcsf, tfs, n_arrays=4)
    np.testing.assert_array_equal(got.numpy(), want)
    dead = meshed.partitions[1]
    dead_rows = np.asarray(jcsf.fids[0])[dead.fiber_start:dead.fiber_stop]
    assert dead.nnz > 0 and bool((got[dead_rows] == 0).all())
    np.testing.assert_array_equal(mesh_stream_mttkrp(tcsf, tfs, n_arrays=4).numpy(),
                                  pair["ref"])
    for lowering in MESH_LOWERINGS:
        with faults.inject(PLAN):
            got1 = mesh_stream_mttkrp(tcsf, tfs, n_arrays=1, lowering=lowering).numpy()
        with jfaults.inject(_jplan(PLAN)):
            want1 = np.asarray(jmesh.mesh_stream_mttkrp(jcsf, jfs, n_arrays=1,
                                                        lowering=lowering))
        clean = mesh_stream_mttkrp(tcsf, tfs, n_arrays=1, lowering=lowering).numpy()
        assert not np.array_equal(got1, clean)
        scale = float(np.abs(want1).max())
        assert np.abs(got1 - want1).max() <= 1e-5 * scale + 4 * _one_code(want1), lowering


# ----------------------------------------------------- spans and drift


def test_mesh_spans_counters_and_drift_row_equal_the_reference(pair):
    """``mesh/shard{i}/plan``, ``mesh/shard{i}/nnz``, ``mesh/stream/execute``
    and, under a plan, ``fault/mesh/shard_values`` with
    ``fault/arrays_lost``: names and args equal to the reference's at one
    array; the ``mesh4`` drift row equal to the reference's, no drift; the
    per-array tracks of the executed plan equal to a planned timeline's."""
    for o in (obs, jobs):
        o.enable()
    plan = faults.FaultPlan(seed=1, array_loss=(faults.ArrayLoss(0),),
                            adc_spikes=(faults.AdcSpike(rate=0.01),))
    for lowering in ("eager", "fused"):
        mesh_stream_mttkrp(pair["tcsf"], pair["tfs"], n_arrays=1, lowering=lowering)
        jmesh.mesh_stream_mttkrp(pair["jcsf"], pair["jfs"], n_arrays=1, lowering=lowering)
    with faults.inject(plan):
        mesh_stream_mttkrp(pair["tcsf"], pair["tfs"], n_arrays=1)
    with jfaults.inject(_jplan(plan)):
        jmesh.mesh_stream_mttkrp(pair["jcsf"], pair["jfs"], n_arrays=1)

    def spans(o):
        return [(e["name"], {k: (v.item() if hasattr(v, "item") else v)
                             for k, v in e.get("args", {}).items()})
                for e in o.get_tracer().events() if e["ph"] == "X"]

    got, want = spans(obs), spans(jobs)
    assert got == want
    assert {"mesh/shard0/plan", "mesh/stream/execute", "fault/mesh/shard_values"} \
        <= {n for n, _ in got}
    assert obs.get_tracer().counters() == jobs.get_tracer().counters()
    for o in (obs, jobs):
        o.disable()
    row = [r for r in obs.drift_report().rows if r.workload == "mttkrp/sparse/mesh4"]
    jrow = [r for r in jobs.drift_report().rows if r.workload == "mttkrp/sparse/mesh4"]
    assert len(row) == len(jrow) == 1 and row[0].backend == "psram-mesh"
    assert row[0].drift == 0.0
    assert row[0].to_dict() == {k: (v.item() if hasattr(v, "item") else v)
                                for k, v in jrow[0].to_dict().items()}
    events = tmesh.mesh_plan_timeline(pair["tcsf"], RANK, n_arrays=4)
    planned = obs.mesh_timeline(pair["tcsf"].fiber_lengths(), RANK, n_arrays=4)

    def strip(evs):   # pids come from the tracer's allocator
        return [{k: v for k, v in e.items() if k != "pid"} for e in evs]

    assert strip(events) == strip(planned)
    with pytest.raises(ValueError, match="arrays"):
        obs.mesh_timeline(pair["tcsf"].fiber_lengths(), RANK, n_arrays=2,
                          schedule=tmesh._mesh_partition(pair["tcsf"], 4, RANK,
                                                         backends.resolve_config(None),
                                                         "makespan"))
