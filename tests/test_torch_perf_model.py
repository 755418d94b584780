"""The price of the port held against the JAX reference on the CPU: the §V
closed forms, the sparse stream counts, the mesh price and its planners,
the energy model, the scaling model, ``describe`` and ``api.estimate`` on
every pricing backend — all **equal** to the reference's, field for field
— and the H100 roofline that stands in the port for the reference's TPU
comparison.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi
from repro import backends as jbackends
from repro.core import perf_model as jpm
from repro.core import scaling as jsc
from repro.core.psram import PsramConfig as JPsramConfig
from repro.sparse import formats as jf
from repro.sparse import partition as jpart
from repro.sparse import synth as jsynth
from repro_torch import api, backends, convert
from repro_torch.core import perf_model as tpm
from repro_torch.core import scaling as tsc
from repro_torch.core.psram import PsramConfig
from repro_torch.sparse import csf_for_mode
from repro_torch.sparse import partition as tpart
from repro_torch.sparse import stream as tstream

RANK = 4
DENSE_WORKLOADS = [dict(), dict(rank=200), dict(i=100, j=100, k=100),
                   dict(i=10**4, j=10**4, k=10**4, rank=8), dict(i=1000, j=50, k=7, rank=5, nnz=4000)]
DENSE_IDS = ["paper", "rank200", "small", "1e4", "nnz"]


def _fields(obj):
    """A dataclass (or None) as plain values, numpy arrays as lists."""
    if obj is None:
        return None
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = _fields(v)
        elif isinstance(v, np.ndarray):
            v = v.tolist()
        out[f.name] = v
    return out


def _same_estimate(got, ref):
    """Every field of an ``Estimate`` equal to the reference's."""
    assert got.backend == ref.backend
    assert _fields(got.config) == _fields(ref.config)
    assert _fields(got.workload) == _fields(ref.workload)
    assert _fields(got.breakdown) == _fields(ref.breakdown)
    assert got.time_s == ref.time_s
    assert _fields(got.counts) == _fields(ref.counts)
    assert _fields(got.energy) == _fields(ref.energy)
    assert got.utilization == ref.utilization
    assert got.sustained_petaops == ref.sustained_petaops


def _fibers(seed=0, rows=2000, nnz=20000, alpha=1.1):
    return jsynth.powerlaw_fiber_lengths(seed, rows, nnz, alpha=alpha)


@pytest.fixture(scope="module")
def data():
    """One small sparse tensor and one dense tensor in both packages."""
    rng = np.random.default_rng(4)
    shape = (30, 20, 12)
    idx = np.unique(np.stack([rng.integers(0, s, 900) for s in shape], axis=1), axis=0)
    idx[:, 0] = np.minimum(idx[:, 0], rng.zipf(1.5, len(idx)) - 1)   # a skewed mode 0
    idx = np.unique(idx, axis=0).astype(np.int32)
    vals = rng.standard_normal(len(idx)).astype(np.float32)
    dense = rng.standard_normal((7, 6, 5)).astype(np.float32)
    return {
        "ref_coo": jf.COO(indices=jnp.asarray(idx), values=jnp.asarray(vals), shape=shape),
        "coo": convert.coo(idx, vals, shape, device="cpu"),
        "triple": (torch.tensor(idx), torch.tensor(vals), shape),
        "ref_triple": (jnp.asarray(idx), jnp.asarray(vals), shape),
        "dense": torch.tensor(dense), "ref_dense": jnp.asarray(dense),
    }


# ------------------------------------------------------------ closed forms

def test_headline_17_petaops():
    """§V-B: 2 · (256 · 32 words) · 52 channels · 20 GHz = 17.03936 PetaOps."""
    cfg = PsramConfig()
    assert tpm.peak_petaops(cfg) == jpm.peak_petaops(JPsramConfig())
    assert round(tpm.peak_petaops(cfg), 10) == 17.03936
    assert tpm.peak_ops(cfg) == 2 * 8192 * 52 * 20e9
    sb = tpm.sustained_mttkrp(cfg, tpm.MTTKRPWorkload())
    assert 16.5 < sb.sustained_petaops <= 17.04
    with pytest.raises(ValueError):
        tpm.peak_ops(PsramConfig(wavelengths=53))


@pytest.mark.parametrize("wl", DENSE_WORKLOADS, ids=DENSE_IDS)
@pytest.mark.parametrize("geometry", [{}, dict(rows=16, word_cols=8, wavelengths=4,
                                               frequency_ghz=5.0)], ids=["paper", "small"])
def test_dense_closed_forms_equal_to_the_reference(wl, geometry):
    """``sustained_mttkrp``, the counted breakdown of the §V schedule, the
    time to solution and the energy model."""
    jcfg, tcfg = JPsramConfig(**geometry), PsramConfig(**geometry)
    jwl, twl = jpm.MTTKRPWorkload(**wl), tpm.MTTKRPWorkload(**wl)
    assert twl.macs == jwl.macs and twl.nonzeros == jwl.nonzeros
    assert _fields(tpm.sustained_mttkrp(tcfg, twl)) == _fields(jpm.sustained_mttkrp(jcfg, jwl))
    assert tpm.sustained_mttkrp(tcfg, twl).utilization == jpm.sustained_mttkrp(jcfg, jwl).utilization
    from repro.core.schedule import build_mttkrp_program as jbuild
    from repro_torch.core.schedule import build_mttkrp_program as tbuild

    assert _fields(tpm.measured_utilization(tbuild(tcfg, twl))) \
        == _fields(jpm.measured_utilization(jbuild(jcfg, jwl)))
    assert tpm.time_to_solution_s(tcfg, twl) == jpm.time_to_solution_s(jcfg, jwl)
    assert _fields(tpm.mttkrp_energy(tcfg, twl)) == _fields(jpm.mttkrp_energy(jcfg, jwl))
    spec = dict(adc_pj_per_conversion=2.5, modulator_fj_per_bit=10.0)
    assert _fields(tpm.mttkrp_energy(tcfg, twl, tpm.EnergySpec(**spec))) \
        == _fields(jpm.mttkrp_energy(jcfg, jwl, jpm.EnergySpec(**spec)))
    assert tpm.ops_per_joule(tcfg, twl) == jpm.ops_per_joule(jcfg, jwl)
    e = tpm.mttkrp_energy(tcfg, twl)
    assert (e + e).total_j == 2 * e.total_j


def test_sweeps_equal_to_the_reference():
    """Fig. 5: sustained PetaOps linear in channels and in frequency."""
    assert tpm.sweep_channels() == jpm.sweep_channels()
    assert tpm.sweep_frequency() == jpm.sweep_frequency()
    pts = tpm.sweep_channels(channels=[13, 26, 52])
    assert abs(pts[1][1] / pts[0][1] - 2.0) < 0.02 and abs(pts[2][1] / pts[1][1] - 2.0) < 0.02
    assert tpm.sweep_frequency(channels=26, freqs=(5, 10)) \
        == jpm.sweep_frequency(channels=26, freqs=(5, 10))


@pytest.mark.parametrize("rank", [32, 5, 40])
@pytest.mark.parametrize("alpha,rows", [(1.1, 2000), (0.0, 20000), (2.0, 300)],
                         ids=["powerlaw", "flat", "heavy"])
def test_sparse_closed_forms_equal_to_the_reference(alpha, rows, rank):
    """``stream_counts`` (equal to the counted stream program), the sparse
    sustained model, and ``breakdown_from_counts``."""
    f = _fibers(rows=rows, alpha=alpha)
    for geometry in ({}, dict(rows=16, word_cols=8, wavelengths=4)):
        jcfg, tcfg = JPsramConfig(**geometry), PsramConfig(**geometry)
        counts = tpm.stream_counts(tcfg, f, rank)
        assert _fields(counts) == _fields(jpm.stream_counts(jcfg, f, rank))
        from repro_torch.core.schedule import count_cycles

        assert counts == count_cycles(tstream.build_stream_program(f, rank, tcfg))
        jwl = jpm.SparseMTTKRPWorkload(fiber_lengths=f, rank=rank)
        twl = tpm.SparseMTTKRPWorkload(fiber_lengths=f, rank=rank)
        assert (twl.nonzeros, twl.n_fibers, twl.macs) == (jwl.nonzeros, jwl.n_fibers, jwl.macs)
        assert _fields(tpm.sustained_mttkrp(tcfg, twl)) == _fields(jpm.sustained_mttkrp(jcfg, jwl))
        assert _fields(tpm.breakdown_from_counts(tcfg, counts)) \
            == _fields(jpm.breakdown_from_counts(jcfg, jpm.stream_counts(jcfg, f, rank)))
    assert _fields(tpm.stream_counts(PsramConfig(), [], rank)) \
        == _fields(jpm.stream_counts(JPsramConfig(), [], rank))


@pytest.mark.parametrize("n_arrays", [1, 3, 8, 64])
@pytest.mark.parametrize("planner", ["nnz", "makespan"])
def test_mesh_price_and_plans_equal_to_the_reference(n_arrays, planner):
    """The planners' boundaries, the per-array stream counts, the fabric's
    all-reduce and the makespan — on a skewed distribution and on one with
    fewer fibers than arrays (empty shards price zero)."""
    cfg, jcfg = PsramConfig(), JPsramConfig()
    for f in (_fibers(alpha=1.4), np.array([5000, 3, 1, 700])):
        got = tpart.plan_partitions(f, n_arrays, 32, cfg, planner=planner)
        ref = jpart.plan_partitions(f, n_arrays, 32, jcfg, planner=planner)
        assert [_fields(p) for p in got] == [_fields(p) for p in ref]
        assert tpart.imbalance(got) == jpart.imbalance(ref)
        fabric = dict(reduce_words=64)
        for wl in ((tpm.SparseMTTKRPWorkload(fiber_lengths=f, rank=32),
                    jpm.SparseMTTKRPWorkload(fiber_lengths=f, rank=32)),
                   (tpm.MeshSparseMTTKRPWorkload(fiber_lengths=f, rank=32, n_arrays=n_arrays,
                                                 out_rows=9000,
                                                 fabric=tpm.MeshFabric(**fabric)),
                    jpm.MeshSparseMTTKRPWorkload(fiber_lengths=f, rank=32, n_arrays=n_arrays,
                                                 out_rows=9000,
                                                 fabric=jpm.MeshFabric(**fabric)))):
            kw = {} if isinstance(wl[0], tpm.MeshSparseMTTKRPWorkload) else dict(n_arrays=n_arrays)
            tprice = tpm.mesh_sparse_price(cfg, wl[0], planner=planner, **kw)
            jprice = jpm.mesh_sparse_price(jcfg, wl[1], planner=planner, **kw)
            assert [_fields(c) for c in tprice.per_array] == [_fields(c) for c in jprice.per_array]
            assert (tprice.reduce_cycles, tprice.makespan_cycles, tprice.total_cycles,
                    tprice.duration_s(cfg)) == (jprice.reduce_cycles, jprice.makespan_cycles,
                                                jprice.total_cycles, jprice.duration_s(jcfg))
            assert _fields(tprice.counts) == _fields(jprice.counts)
    assert tpm.allreduce_cycles(100, 32, n_arrays) == jpm.allreduce_cycles(100, 32, n_arrays)
    with pytest.raises(ValueError, match="planner"):
        tpart.plan_partitions(f, n_arrays, 32, cfg, planner="greedy")
    with pytest.raises(ValueError):
        tpart.nnz_balanced_partitions(f, 0)


@pytest.mark.parametrize("fabric", [dict(), dict(input_gbps=2e4, output_gbps=1e3),
                                    dict(reduction_gbps=1.0, output_bytes_per_mac=1.0)],
                         ids=["default", "narrow_io", "slow_drain"])
def test_scaling_equal_to_the_reference(fabric):
    """The multi-array scaling model: every point of a sweep, the knee, the
    operand reuse."""
    for wl, cfg in ((dict(), {}), (dict(rank=5), dict(wavelengths=13))):
        jargs = (JPsramConfig(**cfg), jpm.MTTKRPWorkload(**wl), jsc.FabricSpec(**fabric))
        targs = (PsramConfig(**cfg), tpm.MTTKRPWorkload(**wl), tsc.FabricSpec(**fabric))
        assert [_fields(p) for p in tsc.sweep(cfg=targs[0], wl=targs[1], fabric=targs[2])] \
            == [_fields(p) for p in jsc.sweep(cfg=jargs[0], wl=jargs[1], fabric=jargs[2])]
        assert tsc.knee(*targs, max_arrays=512) == jsc.knee(*jargs, max_arrays=512)
        assert tsc.operand_reuse(targs[0], targs[1]) == jsc.operand_reuse(jargs[0], jargs[1])
    assert _fields(tsc.scale(4)) == _fields(jsc.scale(4))
    p = tsc.scale(1)
    assert p.compute_petaops == tpm.sustained_mttkrp(PsramConfig(), tpm.MTTKRPWorkload()) \
        .sustained_petaops


def test_h100_roofline():
    """The port's comparison chip: compute term against memory term at the
    data sheet's dense rates, energy at the card's 700 W power limit; the
    array's §V model is faster and spends fewer joules an operation."""
    wl = tpm.MTTKRPWorkload(i=10**4, j=10**4, k=10**4, rank=32)
    ops = 2.0 * wl.macs
    assert tpm.h100_mttkrp_time_s(wl) == max(ops / 1979e12, wl.nonzeros / 3.35e12)
    assert tpm.h100_mttkrp_time_s(wl, int8=False) == max(ops / 989e12, 2 * wl.nonzeros / 3.35e12)
    assert (tpm.H100_F32_FLOPS_PER_S, tpm.H100_POWER_LIMIT_W) == (67e12, 700.0)
    assert tpm.h100_ops_per_joule(wl) == ops / (700.0 * tpm.h100_mttkrp_time_s(wl))
    assert tpm.h100_mttkrp_time_s(wl) > tpm.time_to_solution_s(PsramConfig(), wl)
    assert tpm.ops_per_joule(PsramConfig(), wl) > tpm.h100_ops_per_joule(wl)


# ------------------------------------------------------- backends and api

def test_capabilities_equal_to_the_reference():
    """The pricing backends' capabilities, field for field, as the
    reference's; ``list_backends`` in the reference's order."""
    for name, kw in [("psram-oracle", {}), ("psram-scheduled", {}),
                     ("psram-scheduled", {"compiled": True}), ("psram-stream", {}),
                     ("psram-stream", {"compiled": True}), ("analytical", {})]:
        assert _fields(backends.get(name, **kw).capabilities()) \
            == _fields(jbackends.get(name, **kw).capabilities()), (name, kw)
    assert backends.list_backends() == ("exact", "psram-oracle", "psram-scheduled",
                                        "psram-stream", "hopper", "psram-mesh", "analytical")


@pytest.mark.parametrize("backend,kind", [
    ("analytical", "dense"), ("analytical", "sparse"), ("analytical", "matmul"),
    ("analytical", "mesh"), ("analytical", "raw_dense"), ("analytical", "raw_coo"),
    ("analytical", "raw_triple"), ("analytical", "problem"),
    ("psram-scheduled", "dense"), ("psram-scheduled", "matmul"), ("psram-scheduled", "raw_dense"),
    ("psram-scheduled", "matmul_repeats"),
    ("psram-oracle", "dense"), ("psram-oracle", "matmul"),
    ("psram-stream", "sparse"), ("psram-stream", "raw_coo"), ("psram-stream", "raw_triple"),
    ("psram-stream", "container"),
])
def test_estimate_equal_to_the_reference(backend, kind, data):
    """``api.estimate`` on every pricing backend, for descriptors and for raw
    dense and COO data: every ``Estimate`` field equal to the reference's."""
    f = _fibers(alpha=1.2)
    rank, mode = RANK, 1
    port = {
        "dense": (tpm.MTTKRPWorkload(i=500, j=400, k=300, rank=16), {}),
        "sparse": (tpm.SparseMTTKRPWorkload(fiber_lengths=f, rank=20), {}),
        "matmul": (backends.MatmulWorkload(104, 1024, 2048), {}),
        "matmul_repeats": (backends.MatmulWorkload(8, 300, 50, repeats=7), {}),
        "mesh": (tpm.MeshSparseMTTKRPWorkload(fiber_lengths=f, rank=32, n_arrays=4), {}),
        "raw_dense": (data["dense"], dict(rank=rank)),
        "raw_coo": (data["coo"], dict(rank=rank, mode=mode)),
        "raw_triple": (data["triple"], dict(rank=rank, mode=2)),
        "container": (csf_for_mode(data["coo"], 0), dict(rank=rank, mode=0)),
        "problem": (api.MTTKRPProblem(data["coo"], (torch.zeros(30, 6),), 2), {}),
    }[kind]
    ref = {
        "dense": (jpm.MTTKRPWorkload(i=500, j=400, k=300, rank=16), {}),
        "sparse": (jpm.SparseMTTKRPWorkload(fiber_lengths=f, rank=20), {}),
        "matmul": (jbackends.MatmulWorkload(104, 1024, 2048), {}),
        "matmul_repeats": (jbackends.MatmulWorkload(8, 300, 50, repeats=7), {}),
        "mesh": (jpm.MeshSparseMTTKRPWorkload(fiber_lengths=f, rank=32, n_arrays=4), {}),
        "raw_dense": (data["ref_dense"], dict(rank=rank)),
        "raw_coo": (data["ref_coo"], dict(rank=rank, mode=mode)),
        "raw_triple": (data["ref_triple"], dict(rank=rank, mode=2)),
        "container": (jf.csf_for_mode(data["ref_coo"], 0), dict(rank=rank, mode=0)),
        "problem": (japi.MTTKRPProblem(data["ref_coo"], (jnp.zeros((30, 6)),), 2), {}),
    }[kind]
    got = api.estimate(port[0], backend=backend, **port[1])
    want = japi.estimate(ref[0], backend=backend, **ref[1])
    _same_estimate(got, want)
    if backend == "analytical" and kind in ("dense", "raw_dense", "sparse"):
        assert got.counts is None
    if backend != "analytical" or kind in ("matmul", "mesh"):
        assert got.counts is not None and got.counts.total_cycles > 0


def test_estimate_defaults_and_the_paper_config():
    """``api.estimate`` prices on ``"analytical"`` by default; at the §V-A
    operating point its closed form equals ``"psram-scheduled"``'s counted
    breakdown exactly, and on a sparse distribution ``"psram-stream"``'s."""
    from repro_torch.configs.psram_mttkrp import CONFIG

    assert CONFIG.workload == tpm.MTTKRPWorkload() and CONFIG.array == PsramConfig()
    wl = tpm.MTTKRPWorkload()
    a = api.estimate(wl)
    assert a.backend == "analytical" and a.counts is None
    s = api.estimate(wl, backend="psram-scheduled")
    assert a.breakdown == s.breakdown and a.sustained_petaops == s.sustained_petaops
    sw = tpm.SparseMTTKRPWorkload(fiber_lengths=jsynth.powerlaw_fiber_lengths(
        0, 10**4, 4 * 10**4, alpha=1.1), rank=32)
    assert api.estimate(sw).breakdown == api.estimate(sw, backend="psram-stream").breakdown
    assert api.estimate(sw, backend="psram-stream").counts \
        == tpm.stream_counts(PsramConfig(), sw.fiber_lengths, 32)


def test_describe_and_refusals(data):
    """``describe`` turns raw data into the reference's descriptors; the
    backends refuse what they do not price, as the reference's do."""
    d = backends.describe(data["dense"], rank=3)
    assert d == tpm.MTTKRPWorkload(i=7, j=6, k=5, rank=3)
    for mode in range(3):
        got = backends.describe(data["coo"], rank=3, mode=mode)
        ref = jbackends.describe(data["ref_coo"], rank=3, mode=mode)
        np.testing.assert_array_equal(got.fiber_lengths, ref.fiber_lengths)
        assert got.rank == ref.rank == 3
    wl = backends.MatmulWorkload(2, 3, 4)
    assert backends.describe(wl) is wl
    with pytest.raises(ValueError, match="rank is required"):
        backends.describe(data["dense"])
    with pytest.raises(ValueError, match="3-mode"):
        backends.describe(data["dense"][..., None], rank=2)
    sparse = tpm.SparseMTTKRPWorkload(fiber_lengths=[3, 1], rank=4)
    for name in ("psram-scheduled", "psram-oracle"):
        with pytest.raises(backends.CapabilityError, match="sparse"):
            api.estimate(sparse, backend=name)
    with pytest.raises(backends.CapabilityError, match="fiber-length"):
        api.estimate(tpm.MTTKRPWorkload(), backend="psram-stream")
    with pytest.raises(backends.CapabilityError):
        api.estimate(tpm.MTTKRPWorkload(), backend="hopper")
    with pytest.raises(backends.CapabilityError):
        api.mttkrp(data["dense"], (torch.ones(7, 2),) * 3, 0, backend="analytical")
    with pytest.raises(ValueError):
        api.estimate(tpm.MTTKRPWorkload(), config=PsramConfig(wavelengths=99))
