"""The port's paged serve loop held against the JAX reference on the CPU.

``repro_torch.serve``'s ``traffic``, ``kv_cache``, ``scheduler``, ``loop``,
``engine.offload_report`` and ``transformer.prefill_paged`` against
``repro.serve``'s, at ``granite_8b.reduced()`` (f32) with the reference's
own params carried over by ``convert.model_params``. What is compared, and
how closely:

* the request stream, the page tables and free lists, the scheduler's
  prices and the offload reports' cycles, times, utilizations, energies
  and imbalances: **equal** (numpy draws and counted cycles);
* ``prefill_paged``'s logits at ``last`` and its first ``prompt_len`` cache
  slots: within 1e-5 of max |value| (the models' op-by-op bound);
* the loop itself, at ``speedup=1e9`` where every request is queued before
  the first admission (checked): the same prefills, steps, preemptions,
  per-step batch sizes, modeled cycles, failure reasons, counters, span
  names and per-request tokens (greedy, and Gumbel-sampled from the same
  numpy generator), the slab within 1e-5 of the reference's but for the
  sacrificial slot;
* ``offload_report``'s fidelity probe draws its operands from a torch
  generator, not the reference's JAX keys: its ``projection_rel_err`` lies
  within 0.006 of the reference's, about the spread of either package's
  value over generator seeds at batch 1 (less at batch 4).

Deadlines and the preemption cap depend on wall time and are held on the
port alone, as the reference's own tests hold them.
"""
import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs
from repro.core import perf_model as jpm
from repro.models.registry import get_config as jget_config
from repro.models.registry import get_module as jget_module
from repro.serve import engine as jengine
from repro.serve import kv_cache as jkv
from repro.serve import loop as jloop
from repro.serve import scheduler as jsched
from repro.serve import traffic as jtraffic
from repro_torch import convert, obs, serve
from repro_torch.core import perf_model as tpm
from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import get_config
from repro_torch.serve import (
    OffloadScheduler,
    PagedCacheConfig,
    PagedKVManager,
    ServeEngine,
    ServeLoop,
    ServeLoopConfig,
    TrafficConfig,
    gather_cache,
    offload_report,
    traffic,
)
from repro_torch.serve.engine import _decode_projection_shapes, make_prefill, make_serve_step

REL_ERR_TOL = 0.006
UNLIMITED = 1e9           # speedup: every request queued before the first admission

# the loop's cases: (loop knobs, traffic knobs); "pressure" is the
# reference's page-pressure case (8 pages x 4 slots, 5 x (4 + 20) tokens)
CASES = {
    "no_pressure": (dict(max_batch=4, num_pages=24, page_size=8),
                    dict(n_requests=16, seed=1, rate_rps=60.0, prompt_min=2, prompt_max=24,
                         decode_min=2, decode_max=12)),
    "pressure": (dict(max_batch=4, num_pages=8, page_size=4),
                 dict(n_requests=5, seed=3, rate_rps=500.0, prompt_min=4, prompt_max=4,
                      decode_min=20, decode_max=20)),
    "sampled": (dict(max_batch=4, num_pages=24, page_size=8, temperature=0.7, sample_seed=5),
                dict(n_requests=8, seed=4, rate_rps=60.0, prompt_min=2, prompt_max=24,
                     decode_min=2, decode_max=12)),
}


def _fields(obj):
    """A dataclass as plain values (nested dataclasses too)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = _fields(v) if dataclasses.is_dataclass(v) else v
    return out


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
def model():
    jcfg = jget_config("granite_8b").reduced()
    jparams = jget_module(jcfg).init(jax.random.PRNGKey(0), jcfg)
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    params = convert.model_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _traced_run(loop, tc, tracer_mod):
    tracer_mod.enable()
    try:
        rep = loop.run_sync(tc)
        tracer = tracer_mod.get_tracer()
        return rep, dict(tracer.counters()), {e["name"] for e in tracer.events()}
    finally:
        tracer_mod.disable()
        tracer_mod.get_tracer().clear()


@pytest.fixture(scope="module")
def runs(model):
    """Each case run once by the reference's loop and once by the port's,
    both traced (counters and span names)."""
    jcfg, jparams, cfg, params = model
    out = {}
    for name, (lkw, tkw) in CASES.items():
        tkw = dict(tkw, vocab_size=cfg.vocab_size)
        jl = jloop.ServeLoop(jcfg, jparams, jloop.ServeLoopConfig(speedup=UNLIMITED, **lkw))
        tl = ServeLoop(cfg, params, ServeLoopConfig(speedup=UNLIMITED, **lkw), device="cpu")
        out[name] = (jl, _traced_run(jl, jtraffic.TrafficConfig(**tkw), jobs),
                     tl, _traced_run(tl, TrafficConfig(**tkw), obs))
    return out


# ------------------------------------------------------------------ traffic

@pytest.mark.parametrize("arrival", ["poisson", "bursty"])
def test_traffic_equals_reference(arrival):
    kw = dict(n_requests=200, seed=7, arrival=arrival, rate_rps=8.0, prompt_min=32,
              prompt_max=1024, decode_min=8, decode_max=64, vocab_size=49152)
    got, want = traffic.generate(TrafficConfig(**kw)), jtraffic.generate(jtraffic.TrafficConfig(**kw))
    assert len(got) == len(want) == 200
    for g, w in zip(got, want):
        assert (g.rid, g.arrival_s, g.decode_len, g.prompt_len) == \
            (w.rid, w.arrival_s, w.decode_len, w.prompt_len)
        assert g.prompt.dtype == np.int32 and np.array_equal(g.prompt, w.prompt)
    assert TrafficConfig(**kw).asdict() == jtraffic.TrafficConfig(**kw).asdict()


@pytest.mark.parametrize("bad", [dict(arrival="uniform"), dict(rate_rps=0.0),
                                 dict(prompt_min=10, prompt_max=4)],
                         ids=["arrival", "rate", "lengths"])
def test_traffic_validation_equals_reference(bad):
    with pytest.raises(ValueError) as got:
        traffic.generate(TrafficConfig(**bad))
    with pytest.raises(ValueError) as want:
        jtraffic.generate(jtraffic.TrafficConfig(**bad))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- kv cache

def test_kv_manager_equals_reference():
    """One seeded random sequence of admit, extend and free (unknown ids
    included): every return value, table, free list, slot list, the
    utilization and the fragmentation equal after every operation."""
    cfg = dict(num_pages=40, page_size=4)
    got, want = PagedKVManager(PagedCacheConfig(**cfg)), jkv.PagedKVManager(jkv.PagedCacheConfig(**cfg))
    assert PagedCacheConfig(**cfg).capacity_tokens == 160
    rng = np.random.default_rng(0)
    for _ in range(400):
        op, rid = rng.integers(0, 3), int(rng.integers(0, 12))
        if op == 0:
            n = int(rng.integers(1, 30))
            assert got.admit(rid, n) == want.admit(rid, n)
        elif op == 1:
            if rid in want.tables:
                n = int(rng.integers(1, 6))
                assert got.extend(rid, n) == want.extend(rid, n)
            else:
                with pytest.raises(KeyError, match="unknown request id"):
                    got.extend(rid)
        else:
            got.free_request(rid)
            want.free_request(rid)
        assert got.free == want.free and got.tables == want.tables
        assert got.lengths == want.lengths
        for r in want.tables:
            assert np.array_equal(got.physical_slots(r), want.physical_slots(r))
        assert got.allocated_pages == want.allocated_pages
        assert got.utilization() == want.utilization()
        assert got.fragmentation() == want.fragmentation()


def test_gather_cache_equals_reference():
    flat = np.random.default_rng(1).standard_normal((24, 2, 3)).astype(np.float32)
    slots = np.array([5, 0, 23, 5])
    want = np.asarray(jkv.gather_cache(jnp.asarray(flat), jnp.asarray(slots)))
    assert np.array_equal(gather_cache(torch.tensor(flat), slots).numpy(), want)
    # along another axis, any index shape: the loop's (L, 2, slots, ...) slab
    slab = torch.tensor(flat.transpose(1, 0, 2).copy())          # (2, 24, 3)
    idx = torch.tensor([[5, 0], [23, 5]])
    got = gather_cache(slab, idx, dim=1)
    assert tuple(got.shape) == (2, 2, 2, 3)
    assert torch.equal(got, slab[:, idx])


# -------------------------------------------------------------- prefill_paged

@pytest.mark.parametrize("arch", ["granite_8b", "gemma2_27b"])
def test_prefill_paged_matches_reference(arch):
    """Logits at ``last`` and the first ``prompt_len`` slots of every layer's
    k/v, a prompt right-padded to a bucket; ``last`` as an int or a 0-d
    tensor gives the same."""
    jcfg = jget_config(arch).reduced()
    jparams = jget_module(jcfg).init(jax.random.PRNGKey(0), jcfg)
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    params = convert.model_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    plen, s_pad = 11, 16
    toks = np.zeros((1, s_pad), np.int32)
    toks[0, :plen] = np.random.default_rng(3).integers(2, cfg.vocab_size, plen)
    jlogits, jcaches = jengine.make_prefill(jcfg, paged=True)(
        jparams, jnp.asarray(toks), jnp.int32(plen - 1))
    logits, caches = make_prefill(cfg, paged=True)(params, torch.tensor(toks), plen - 1)
    want = np.asarray(jlogits)
    assert tuple(logits.shape) == want.shape
    assert float(np.abs(logits.numpy() - want).max()) <= 1e-5 * float(np.abs(want).max())
    again, _ = transformer.prefill_paged(params, torch.tensor(toks), cfg, torch.tensor(plen - 1))
    assert torch.equal(again, logits)
    want_caches = convert.model_cache(jax.tree.map(np.asarray, jcaches), device="cpu")
    assert len(caches) == cfg.num_groups
    for g_got, g_want in zip(caches, want_caches):
        assert set(g_got) == set(g_want)
        for key, layer in g_got.items():
            for name in ("k", "v"):
                got, ref = layer[name], g_want[key][name].numpy()
                assert tuple(got.shape) == (1, s_pad, cfg.n_kv_heads, cfg.head_dim)
                err = float(np.abs(got[:, :plen].numpy() - ref[:, :plen]).max())
                assert err <= 1e-5 * float(np.abs(ref[:, :plen]).max())


# ---------------------------------------------------------------- scheduler

def test_scheduler_prices_equal_reference(model):
    jcfg, _, cfg, _ = model
    got, want = OffloadScheduler(n_arrays=4), jsched.OffloadScheduler(n_arrays=4)
    for batch in (1, 4, 8):
        p = got.price_decode_batch(cfg, batch)
        assert _fields(p) == _fields(want.price_decode_batch(jcfg, batch))
        assert got.price_decode_batch(cfg, batch) is p             # cached
    fibers = np.array([100, 40, 7, 3, 1] * 8)
    for n_arrays in (1, 4):
        got, want = OffloadScheduler(n_arrays=n_arrays), jsched.OffloadScheduler(n_arrays=n_arrays)
        assert _fields(got.price_sparse(fibers, rank=16)) == \
            _fields(want.price_sparse(fibers, rank=16))
        assert _fields(got.decide_sparse(fibers, 16, host_s=1e-6)) == \
            _fields(want.decide_sparse(fibers, 16, host_s=1e-6))
    with pytest.raises(ValueError, match="at least one array"):
        OffloadScheduler(n_arrays=0)


def test_scheduler_decisions_and_host_ema_equal_reference(model):
    """The reference's host-fallback walk, decision by decision."""
    jcfg, _, cfg, _ = model
    got, want = OffloadScheduler(n_arrays=2), jsched.OffloadScheduler(n_arrays=2)
    seen = []
    for measured in [None, 1e-12] + [10.0] * 40:
        if measured is not None:
            got.observe_host(2, measured)
            want.observe_host(2, measured)
        d, w = got.decide_decode(cfg, 2), want.decide_decode(jcfg, 2)
        assert _fields(d) == _fields(w) and d.offloaded == w.offloaded
        seen.append(d.target)
    assert seen[0] == "psram" and seen[1] == "host" and seen[-1] == "psram"


def test_scheduler_mark_array_failed():
    """The reference's ``test_scheduler_mark_array_failed``
    (``tests/test_faults.py``), on the port, with the prices equal to the
    reference scheduler's after each loss and the ``fault/arrays_lost``
    counter."""
    arch = get_config("granite_8b").reduced()
    jarch = jget_config("granite_8b").reduced()
    sch = OffloadScheduler(n_arrays=4)
    ref = jsched.OffloadScheduler(n_arrays=4)
    p4 = sch.price_decode_batch(arch, 2)
    obs.enable()
    assert sch.mark_array_failed() == 3 == ref.mark_array_failed()
    p3 = sch.price_decode_batch(arch, 2)
    assert p3 is not p4
    assert p3.n_arrays == 3 and p3.makespan_cycles >= p4.makespan_cycles
    assert _fields(p3) == _fields(ref.price_decode_batch(jarch, 2))
    assert sch.mark_array_failed(2) == 1
    assert obs.get_tracer().counters()["fault/arrays_lost"] == 3
    with pytest.raises(ValueError, match="survive"):
        sch.mark_array_failed()
    with pytest.raises(ValueError, match="at least one"):
        sch.mark_array_failed(0)


# ----------------------------------------------------------- offload reports

def _same_report(got, want):
    assert set(got) == set(want)
    for key in ("cycles", "utilization", "energy", "model"):
        if key in want:
            assert _fields(got[key]) == _fields(want[key]), key
    for key in ("backend", "time_s", "imbalance", "makespan_cycles", "reduce_cycles",
                "n_arrays"):
        if key in want:
            assert got[key] == want[key], key


@pytest.mark.parametrize("batch", [1, 4])
def test_projection_report_equals_reference(model, batch):
    jcfg, _, cfg, _ = model
    assert _decode_projection_shapes(cfg, batch) == jengine._decode_projection_shapes(jcfg, batch)
    got = offload_report(cfg, batch=batch, device="cpu")
    want = jengine.offload_report(jcfg, batch=batch)
    _same_report(got, want)
    assert abs(got["projection_rel_err"] - want["projection_rel_err"]) <= REL_ERR_TOL
    # the engine's method is the module function on its device
    eng = ServeEngine(cfg, model[3], max_len=8, device="cpu")
    again = eng.offload_report(batch=batch)
    _same_report(again, want)
    assert again["projection_rel_err"] == got["projection_rel_err"]
    assert offload_report(cfg, batch=batch, fidelity=False)["projection_rel_err"] is None


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "mamba2_370m", "jamba_1p5_large",
                                  "seamless_m4t_large_v2"])
def test_projection_shapes_equal_reference_every_family(arch):
    jcfg = jget_config(arch)
    cfg = get_config(arch)
    assert _decode_projection_shapes(cfg, 8) == jengine._decode_projection_shapes(jcfg, 8)
    _same_report(offload_report(cfg, batch=8, fidelity=False),
                 jengine.offload_report(jcfg, batch=8, fidelity=False))


@pytest.mark.parametrize("n_arrays", [1, 4])
def test_sparse_report_equals_reference(n_arrays):
    fibers = np.random.default_rng(2).zipf(1.6, 300).clip(1, 500)
    _same_report(offload_report(fibers, n_arrays=n_arrays, rank=16),
                 jengine.offload_report(fibers, n_arrays=n_arrays, rank=16))
    fabric = dict(reduce_words=64)
    mesh = tpm.MeshSparseMTTKRPWorkload(fiber_lengths=fibers, rank=16, n_arrays=n_arrays,
                                        out_rows=400, fabric=tpm.MeshFabric(**fabric))
    jmesh = jpm.MeshSparseMTTKRPWorkload(fiber_lengths=fibers, rank=16, n_arrays=n_arrays,
                                         out_rows=400, fabric=jpm.MeshFabric(**fabric))
    _same_report(offload_report(mesh), jengine.offload_report(jmesh))


def test_dense_report_equals_reference():
    _same_report(offload_report(tpm.MTTKRPWorkload(i=64, j=48, k=40, rank=16)),
                 jengine.offload_report(jpm.MTTKRPWorkload(i=64, j=48, k=40, rank=16)))
    with pytest.raises(TypeError, match="offload_report takes"):
        offload_report("granite")
    from repro_torch.backends import CapabilityError
    with pytest.raises(CapabilityError, match="cannot price a sparse"):
        offload_report([3, 2, 1], backend="psram-scheduled")


# ------------------------------------------------------------------ guards

def test_guards_raise():
    enc = get_config("seamless_m4t_large_v2")
    with pytest.raises(ValueError, match="delta-form"):
        make_serve_step(enc, deltas=True)
    with pytest.raises(ValueError, match="paged prefill"):
        make_prefill(enc, paged=True)
    with pytest.raises(ValueError, match="paged prefill"):
        ServeLoop(enc.reduced(), loop_cfg=ServeLoopConfig(num_pages=4, page_size=4),
                  device="cpu")
    with pytest.raises(ValueError, match="cache_len"):
        make_prefill(get_config("granite_8b"))
    for arch in ("mamba2_370m", "jamba_1p5_large"):
        with pytest.raises(ValueError, match="all-attention"):
            ServeLoop(get_config(arch).reduced(),
                      loop_cfg=ServeLoopConfig(num_pages=4, page_size=4), device="cpu")


@pytest.mark.parametrize("name", ["photonic_offload_report", "sparse_offload_report"])
def test_removed_adapters_raise_pointed_errors(name):
    from repro_torch.serve import engine

    for where in (serve, engine):
        with pytest.raises(AttributeError, match="offload_report") as err:
            getattr(where, name)
        assert "removed" in str(err.value)
    with pytest.raises(AttributeError, match="has no attribute"):
        getattr(serve, "no_such_thing")


# ---------------------------------------------------------------- the loop

@pytest.mark.parametrize("case", list(CASES))
def test_loop_matches_reference(runs, case):
    jl, (jrep, jcounters, jnames), tl, (rep, counters, names) = runs[case]
    for r in (jrep, rep):       # every request queued before the first admission
        assert max(x.arrival_s for x in r.records) <= \
            min(x.admitted_s for x in r.records if x.admitted_s is not None)
    assert (rep.n_prefills, rep.n_steps, rep.preemptions, rep.leaked_pages) == \
        (jrep.n_prefills, jrep.n_steps, jrep.preemptions, jrep.leaked_pages)
    assert rep.leaked_pages == 0
    for key in ("batch", "target", "modeled_s", "makespan_cycles", "n_arrays"):
        assert [o[key] for o in rep.offload] == [o[key] for o in jrep.offload], key
    s, js = rep.summary(), jrep.summary()
    for key in ("completed", "rejected", "failed", "failure_reasons", "preemptions",
                "peak_utilization", "mean_fragmentation", "mean_modeled_step_s"):
        assert s[key] == js[key], key
    for got, want in zip(rep.records, jrep.records):
        assert (got.rid, got.n_generated, got.preemptions, got.rejected, got.failed,
                got.failure) == (want.rid, want.n_generated, want.preemptions,
                                 want.rejected, want.failed, want.failure)
        assert got.tokens == want.tokens, got.rid
    assert counters == jcounters
    assert names == jnames
    assert {"serve/admit", "serve/prefill", "serve/decode", "serve/offload"} <= names
    if case == "pressure":
        assert rep.preemptions >= 1 and "serve/evict" in names
        assert all(r.n_generated == 20 for r in rep.completed)
    # the physical KV: every slot but the sacrificial one within the models'
    # op-by-op bound of the reference's (one slab a leaf there)
    layers = [(g, key) for g in range(tl.cfg.num_groups) for key in sorted(jl.slab)]
    for i, (g, key) in enumerate(layers):
        for j, name in enumerate(("k", "v")):
            want = np.asarray(jl.slab[key][name])[:-1, g]
            got = tl.slab[i, j, :-1].numpy()
            assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max())


def test_loop_tokens_equal_dense_engine(model, runs):
    """The reference test's own check: every request completed without
    preemption reproduces the port's dense ``ServeEngine`` at batch 1."""
    _, _, cfg, params = model
    rep = runs["no_pressure"][3][0]
    reqs = {r.rid: r for r in traffic.generate(TrafficConfig(
        **CASES["no_pressure"][1], vocab_size=cfg.vocab_size))}
    eng = ServeEngine(cfg, params, max_len=64, device="cpu")
    checked = 0
    for rec in rep.completed[:12]:
        if rec.preemptions:
            continue
        r = reqs[rec.rid]
        toks = eng.generate(torch.tensor(r.prompt[None]), r.prompt_len,
                            max_new_tokens=rec.n_generated)
        assert toks[0].tolist() == rec.tokens
        checked += 1
    assert checked >= 8


def test_paged_step_equals_dense_step(model):
    """One paged decode step on rows at mixed lengths (one free row) against
    ``decode_step`` on a dense cache holding the same tokens: the strict
    mask hides each row's stale slots, so the logits agree to f32 rounding."""
    _, _, cfg, params = model
    loop = ServeLoop(cfg, params, ServeLoopConfig(max_batch=4, num_pages=16, page_size=4),
                     device="cpu")
    lens = [3, 9, 6]
    rng = np.random.default_rng(8)
    prompts = [rng.integers(2, cfg.vocab_size, n).astype(np.int32) for n in lens]
    rows = []
    for rid, p in enumerate(prompts):
        req = traffic.Request(rid=rid, arrival_s=0.0, prompt=p, decode_len=4)
        assert loop.kv.admit(rid, len(p))
        tok = loop._prefill_one(req)
        assert loop.kv.extend(rid, 1)
        rows.append(serve.loop._Active(req=req, row=rid, admit_seq=rid, next_token=tok,
                                       pos=len(p), generated=[tok]))
    got = loop._decode(*loop._step_inputs(rows))[:len(rows)]
    dense = np.zeros((len(rows), max(lens)), np.int32)
    for i, p in enumerate(prompts):
        dense[i, :len(p)] = p
    _, cache = transformer.prefill(params, torch.tensor(dense), cfg, max(lens) + 1)
    want, cache = transformer.decode_step(
        params, cache, torch.tensor([a.next_token for a in rows], dtype=torch.int32),
        torch.tensor(lens, dtype=torch.int32), cfg)
    err = float(np.abs(got - want.numpy()).max())
    assert err <= 1e-5 * float(np.abs(want.numpy()).max())
    # each row's whole history, the step's new token included, sits in its
    # own slots as the dense cache holds it
    for a in rows:
        slots = loop.kv.physical_slots(a.req.rid)[:a.pos + 1]
        for i, (g, key) in enumerate(loop._layers):
            for j, name in enumerate(("k", "v")):
                ref = cache[g][key][name][a.row, :a.pos + 1]
                assert torch.allclose(loop.slab[i, j, slots], ref, rtol=0,
                                      atol=1e-5 * float(ref.abs().max()))


def test_warmup_touches_only_the_sacrificial_slot(model, runs):
    _, _, cfg, params = model
    lkw, tkw = CASES["no_pressure"]
    loop = ServeLoop(cfg, params, ServeLoopConfig(speedup=UNLIMITED, **lkw), device="cpu")
    # prompts up to 20 -> pad buckets 8/16/32; positions up to 29 -> view
    # buckets 8/16/32: 3 + 3 calls
    assert loop.warmup(max_prompt=20, max_decode=10) == 6
    assert loop.kv.allocated_pages == 0
    assert not loop.slab[:, :, :-1].any() and loop.slab[:, :, -1].any()
    rep = loop.run_sync(TrafficConfig(**tkw, vocab_size=cfg.vocab_size))
    cold = runs["no_pressure"][3][0]
    assert rep.leaked_pages == 0
    assert [r.tokens for r in rep.records] == [r.tokens for r in cold.records]


def _loop(model, **kw):
    _, _, cfg, params = model
    lc = dict(max_batch=4, num_pages=24, page_size=8, speedup=1000.0)
    lc.update(kw)
    return ServeLoop(cfg, params, ServeLoopConfig(**lc), device="cpu")


def test_loop_preemption_cap_fails_cleanly(model):
    loop = _loop(model, num_pages=8, page_size=4, max_preemptions=0)
    tc = TrafficConfig(n_requests=5, seed=3, rate_rps=500.0, prompt_min=4, prompt_max=4,
                       decode_min=20, decode_max=20, vocab_size=model[2].vocab_size)
    rep = loop.run_sync(tc)
    assert rep.preemptions >= 1
    assert rep.failed and all(r.failure == "preempt-limit" for r in rep.failed)
    assert len(rep.completed) + len(rep.failed) == 5
    assert all(r.n_generated == 20 for r in rep.completed)
    assert rep.leaked_pages == 0
    s = rep.summary()
    assert s["failed"] == len(rep.failed)
    assert s["failure_reasons"] == {"preempt-limit": len(rep.failed)}


def test_loop_deadline_sheds_overdue_requests(model):
    tc = TrafficConfig(n_requests=4, seed=2, rate_rps=200.0, prompt_min=2, prompt_max=8,
                       decode_min=2, decode_max=4, vocab_size=model[2].vocab_size)
    obs.enable()
    rep = _loop(model, deadline_s=1e-9).run_sync(tc)
    assert not rep.completed and len(rep.failed) == 4
    assert all(r.failure == "deadline" for r in rep.failed)
    assert rep.leaked_pages == 0
    assert rep.summary()["failure_reasons"] == {"deadline": 4}
    assert obs.get_tracer().counters()["serve/failed"] == 4
    assert "serve/fail" in {e["name"] for e in obs.get_tracer().events()}
    obs.disable()
    assert len(_loop(model, deadline_s=300.0).run_sync(tc).completed) == 4


def test_loop_rejects_never_fitting_requests(model):
    loop = _loop(model, max_batch=2, num_pages=8, page_size=4)
    tc = TrafficConfig(n_requests=3, seed=0, rate_rps=100.0, prompt_min=40, prompt_max=40,
                       decode_min=4, decode_max=4, vocab_size=model[2].vocab_size)
    rep = loop.run_sync(tc)
    assert len(rep.rejected) == 3 and not rep.completed
    assert rep.leaked_pages == 0 and rep.n_steps == 0


def test_loop_accepts_request_list_and_async(model):
    reqs = traffic.generate(TrafficConfig(
        n_requests=4, seed=2, rate_rps=200.0, prompt_min=2, prompt_max=8,
        decode_min=2, decode_max=4, vocab_size=model[2].vocab_size))
    rep = asyncio.run(_loop(model).run(reqs))
    assert len(rep.completed) == 4
    for rec in rep.completed:
        assert rec.ttft_s is not None and rec.latency_s >= rec.ttft_s


def test_loop_takes_the_card_unless_asked_for_the_cpu(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeLoop(model[2], model[3], ServeLoopConfig(num_pages=4, page_size=4))
