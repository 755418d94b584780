"""The rest of ``repro_torch.faults`` held against the JAX package's
``repro.faults`` on the CPU: the schedule executor's fault hooks, ABFT on
the matmul and the sparse MTTKRP, degraded mode, the lazy names, and the
``fault/*`` spans and counters. Each side arms its own package's plan of
the same fields (``_twin``); both draw their sites from the same seeded
numpy streams.

Contracts, each with its tolerance:

* **The hooks**: with each fault model armed (stuck-at-0 and stuck-at-1
  bits, dead WDM channels, laser drift, transient spikes across an epoch
  bump), the port's ``execute`` is **bit-equal** to the reference's, on a
  shape whose K and N split into several tiles and with ``_CHUNK_BYTES``
  small enough that every chunk holds one K-tile of one N-tile; disarmed, it
  is the clean executor's bits; ``compiled=True`` runs the eager executor
  while a plan is armed.
* **ABFT**: every report equal to the reference's field for field; the
  matmul's ``y`` bit-equal; the MTTKRP's ``y`` within one ADC code of the
  jitted reference (the settled quantized-chain contract: XLA rewrites
  ``amax / 127`` into a reciprocal multiply); no false positive in the
  seeded sweep.
* **Degraded mode**: bit-identical to a mesh that never failed; the
  reports equal; ids past the mesh ignored; losing every array raises.
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
from repro.core import schedule as jschedule
from repro.sparse import csf_for_mode as j_csf_for_mode
from repro.sparse import mesh_stream_mttkrp as j_mesh_stream_mttkrp
from repro.sparse import powerlaw_coo as j_powerlaw_coo
from repro.sparse.formats import COO as JCOO
from repro_torch import backends, convert, faults, obs
from repro_torch.core import schedule
from repro_torch.faults import abft as tabft
from repro_torch.faults import plan as plan_mod
from repro_torch.sparse import csf_for_mode, mesh_stream_mttkrp

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

# K = 600 and N = 100 split into 3 K-tiles x 4 N-tiles of the 256 x 32
# array; M = 60 into two WDM chunks of 52
HOOK_SHAPE = (60, 600, 100)


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


def _twin(plan):
    """The reference's plan of the same fields."""
    def conv(f):
        return getattr(jfaults, type(f).__name__)(**dataclasses.asdict(f))
    return jfaults.FaultPlan(
        seed=plan.seed,
        stuck_bits=tuple(conv(f) for f in plan.stuck_bits),
        adc_spikes=tuple(conv(f) for f in plan.adc_spikes),
        dead_channels=tuple(conv(f) for f in plan.dead_channels),
        laser_drift=None if plan.laser_drift is None else conv(plan.laser_drift),
        array_loss=tuple(conv(f) for f in plan.array_loss),
    )


def _operands(m, k, n, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (scale * rng.normal(size=(m, k))).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    return x, w


def _report(rep):
    """A report's fields and derived cycles, in plain Python."""
    out = {k: (v.item() if hasattr(v, "item") else v)
           for k, v in dataclasses.asdict(rep).items()}
    out["detected"] = [int(t) for t in rep.detected]
    out["recovery_cycles"] = int(rep.recovery_cycles)
    return out


# ------------------------------------------------------------------ hooks


HOOK_PLANS = {
    "stuck_at_1": faults.FaultPlan(seed=7, stuck_bits=(faults.StuckBit(rate=5e-3),)),
    "stuck_at_0": faults.FaultPlan(seed=3, stuck_bits=(
        faults.StuckBit(bit=5, value=0, rate=0.05), faults.StuckBit(bit=1, value=0, rate=0.2))),
    "dead_channels": faults.FaultPlan(seed=1, dead_channels=(faults.DeadChannel((0, 5, 60)),
                                                             faults.DeadChannel((51,)))),
    "laser_drift": faults.FaultPlan(seed=1, laser_drift=faults.LaserDrift(0.93)),
    "spikes": faults.FaultPlan(seed=2, adc_spikes=(
        faults.AdcSpike(rate=0.01, magnitude=0.5),
        faults.AdcSpike(rate=0.002, magnitude=-0.25, transient=False))),
    "all": faults.FaultPlan(seed=9, stuck_bits=(faults.StuckBit(rate=0.01),),
                            adc_spikes=(faults.AdcSpike(rate=0.005),),
                            dead_channels=(faults.DeadChannel((7,)),),
                            laser_drift=faults.LaserDrift(1.02)),
}


@pytest.fixture(scope="module")
def hook_case(cfg):
    m, k, n = HOOK_SHAPE
    x, w = _operands(m, k, n, seed=4)
    jcfg = jbackends.resolve_config(None)
    return dict(x=x, w=w, prog=schedule.build_matmul_program(m, k, n, cfg),
                jprog=jschedule.build_matmul_program(m, k, n, jcfg))


def _reference_runs(case, plan):
    """The reference's executor under ``plan``: epoch 0, then epoch 1."""
    x, w = jnp.asarray(case["x"]), jnp.asarray(case["w"])
    with jfaults.inject(_twin(plan)):
        first = np.asarray(jschedule.execute(case["jprog"], x, w))
        jfaults.bump_epoch()
        second = np.asarray(jschedule.execute(case["jprog"], x, w))
    return first, second


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
@pytest.mark.parametrize("name", sorted(HOOK_PLANS))
def test_hooks_bit_equal_to_the_reference(hook_case, cfg, monkeypatch, name, chunked):
    """Each fault model armed: the port's executor gives the reference's
    bits at epoch 0 and, after ``bump_epoch``, at epoch 1 (transient spikes
    re-rolled, persistent ones recurring); with one K-tile of one N-tile a
    chunk, the masks drawn once over the whole stack land on the same
    cells."""
    m, k, n = HOOK_SHAPE
    kt, nt = -(-k // cfg.rows), -(-n // cfg.word_cols)
    if chunked:
        monkeypatch.setattr(schedule, "_CHUNK_BYTES", 1 << 14)
    cells = -(-m // cfg.wavelengths) * cfg.wavelengths
    assert schedule._chunking(cfg.rows, cfg.word_cols, cells, kt, nt) == \
        ((1, 1) if chunked else (kt, nt))
    plan = HOOK_PLANS[name]
    want0, want1 = _reference_runs(hook_case, plan)
    x, w = torch.tensor(hook_case["x"]), torch.tensor(hook_case["w"])
    with faults.inject(plan):
        got0 = schedule.execute(hook_case["prog"], x, w).numpy()
        faults.bump_epoch()
        got1 = schedule.execute(hook_case["prog"], x, w).numpy()
    np.testing.assert_array_equal(got0, want0)
    np.testing.assert_array_equal(got1, want1)
    clean = schedule.execute(hook_case["prog"], x, w).numpy()
    assert not np.array_equal(got0, clean), "the plan had no effect"
    if name == "spikes":
        assert not np.array_equal(got0, got1)        # the transient sites re-rolled


def test_disarmed_path_is_bit_identical(hook_case):
    """No plan (and a plan that touches only the mesh): the clean
    executor's bits, equal to the reference's clean run."""
    x, w = torch.tensor(hook_case["x"]), torch.tensor(hook_case["w"])
    clean = schedule.execute(hook_case["prog"], x, w).numpy()
    want = np.asarray(jschedule.execute(hook_case["jprog"], jnp.asarray(hook_case["x"]),
                                        jnp.asarray(hook_case["w"])))
    np.testing.assert_array_equal(clean, want)
    with faults.inject(faults.FaultPlan(array_loss=(faults.ArrayLoss(0),))):
        np.testing.assert_array_equal(schedule.execute(hook_case["prog"], x, w).numpy(), clean)
    with faults.inject(HOOK_PLANS["stuck_at_1"]):
        schedule.execute(hook_case["prog"], x, w)
    np.testing.assert_array_equal(schedule.execute(hook_case["prog"], x, w).numpy(), clean)


def test_compiled_runs_eager_while_a_plan_is_armed(hook_case):
    """``compiled=True`` under an armed plan is the eager faulty run, equal
    to the reference's compiled call, which falls back to its eager
    executor (on the card no graph is captured: the ``cuda`` tests)."""
    x, w = torch.tensor(hook_case["x"]), torch.tensor(hook_case["w"])
    plan = HOOK_PLANS["all"]
    with faults.inject(plan):
        eager = schedule.execute(hook_case["prog"], x, w).numpy()
        compiled = schedule.execute(hook_case["prog"], x, w, compiled=True).numpy()
    with jfaults.inject(_twin(plan)):
        want = np.asarray(jschedule.execute(hook_case["jprog"], jnp.asarray(hook_case["x"]),
                                            jnp.asarray(hook_case["w"]), compiled=True))
    np.testing.assert_array_equal(compiled, eager)
    np.testing.assert_array_equal(compiled, want)


def test_fault_sites_slices_equal_the_whole_stack_draw(cfg):
    """``_FaultSites`` draws each mask once over the reference's whole stack
    shape: the slice a chunk takes is that draw's slice, and the stored
    words it corrupts equal ``corrupt_stored`` over the whole stack."""
    plan = faults.FaultPlan(seed=5, stuck_bits=(faults.StuckBit(rate=0.1),
                                                faults.StuckBit(bit=0, value=0, rate=0.3)))
    kt, nt, mt = 3, 4, 2
    sites = schedule._FaultSites(plan, rows=cfg.rows, cols=cfg.word_cols, wav=cfg.wavelengths,
                                 kt=kt, nt=nt, mt=mt, device="cpu")
    rng = np.random.default_rng(0)
    q = rng.integers(-127, 128, (kt, nt, cfg.rows, cfg.word_cols)).astype(np.int8)
    whole = plan_mod.corrupt_stored(plan, q)
    pieces = np.concatenate([
        np.concatenate([sites.stored(torch.tensor(q[t:t + 1, j:j + 1]), t, j).numpy()
                        for j in range(nt)], axis=1) for t in range(kt)], axis=0)
    np.testing.assert_array_equal(pieces, whole)
    assert pieces.dtype == np.int32


# ------------------------------------------------------------- ABFT: matmul


def test_abft_matmul_detects_and_corrects_like_the_reference(cfg):
    """The acceptance case: a stuck-MSB plan on the §V-A matmul. Detected
    tiles, retries, recoveries, fallbacks and every cycle field equal the
    reference's; the corrected ``y`` is bit-equal and within the ADC
    envelope of the clean run."""
    x, w = _operands(8, 64, 96, seed=0)
    plan = faults.FaultPlan(seed=7, stuck_bits=(faults.StuckBit(rate=5e-3),))
    with jfaults.inject(_twin(plan)):
        jy, jrep = jfaults.abft_matmul(jnp.asarray(x), jnp.asarray(w))
    with faults.inject(plan):
        y, rep = faults.abft_matmul(torch.tensor(x), torch.tensor(w), cfg)
    assert _report(rep) == _report(jrep)
    assert rep.faulty and rep.fallbacks >= 1
    assert rep.recovered + rep.fallbacks == len(rep.detected)
    assert rep.recovery_s(cfg) == jrep.recovery_s(jbackends.resolve_config(None))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    clean = schedule.execute(schedule.build_matmul_program(8, 64, 96, cfg),
                             torch.tensor(x), torch.tensor(w)).numpy()
    assert np.max(np.abs(y.numpy() - clean)) / np.max(np.abs(clean)) <= rep.rel_tol


def test_abft_matmul_transient_spikes_recover_like_the_reference(cfg):
    """Transient spikes clear on an epoch-bumped re-drive: recoveries rather
    than fallbacks, the report and ``y`` equal to the reference's."""
    x, w = _operands(16, 100, 130, seed=2)
    plan = faults.FaultPlan(seed=12, adc_spikes=(faults.AdcSpike(rate=1e-3, magnitude=0.5),))
    with jfaults.inject(_twin(plan)):
        jy, jrep = jfaults.abft_matmul(jnp.asarray(x), jnp.asarray(w))
    with faults.inject(plan):
        y, rep = faults.abft_matmul(torch.tensor(x), torch.tensor(w), cfg)
    assert _report(rep) == _report(jrep)
    assert rep.faulty and rep.recovered >= 1
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


def test_abft_matmul_clean_run_is_untouched(cfg):
    x, w = _operands(6, 48, 64, seed=1)
    y, rep = faults.abft_matmul(torch.tensor(x), torch.tensor(w), cfg)
    jy, jrep = jfaults.abft_matmul(jnp.asarray(x), jnp.asarray(w))
    assert _report(rep) == _report(jrep)
    assert not rep.faulty and rep.retries == rep.fallbacks == 0
    assert rep.recovery_cycles == 0 and rep.checksum_cycles > 0
    ref = schedule.execute(schedule.build_matmul_program(6, 48, 64, cfg),
                           torch.tensor(x), torch.tensor(w))
    assert torch.equal(y, ref)


def test_tile_checksums_equal_the_reference():
    w = _operands(4, 70, 130, seed=3)[1]
    from repro.faults import abft as jabft

    np.testing.assert_array_equal(tabft._tile_checksums(w, 32), jabft._tile_checksums(w, 32))


# -------------------------------------------------------------- ABFT: MTTKRP


@pytest.fixture(scope="module")
def sparse_case():
    """The reference test's operand set, carried to the port: CSF, factors,
    and both packages' clean one-array mesh results."""
    rng = np.random.default_rng(0)
    shape, nnz, rank = (64, 48, 40), 2000, 32
    idx = np.stack([rng.integers(0, s, nnz) for s in shape], 1).astype(np.int32)
    vals = rng.normal(size=nnz).astype(np.float32)
    fs = [rng.normal(size=(s, rank)).astype(np.float32) for s in shape]
    jcsf = j_csf_for_mode(JCOO(indices=jnp.asarray(idx), values=jnp.asarray(vals),
                               shape=shape), 0)
    jfs = tuple(jnp.asarray(f) for f in fs)
    tcsf = csf_for_mode(convert.coo(idx, vals, shape, device="cpu"), 0)
    tfs = tuple(torch.tensor(f) for f in fs)
    return dict(jcsf=jcsf, jfs=jfs, tcsf=tcsf, tfs=tfs,
                jclean=np.asarray(j_mesh_stream_mttkrp(jcsf, jfs, n_arrays=1)),
                clean=mesh_stream_mttkrp(tcsf, tfs, n_arrays=1).numpy())


def _one_code(out, adc_bits=16):
    return 2.0 ** (1 - adc_bits) * float(np.abs(out).max())


def test_group_reference_sums_are_np_add_at(sparse_case):
    """The exact group checksums are ``np.add.at``'s sequential sums, bit
    for bit, and equal to the reference's ``_group_reference``."""
    from repro.faults import abft as jabft
    from repro_torch.core.mttkrp import cp_chain_exact

    csf, fs = sparse_case["tcsf"], sparse_case["tfs"]
    groups = tabft._fiber_groups(len(csf.fids[0]), 5)
    c, l1 = tabft._group_reference(csf, fs, 0, groups)
    scaled = cp_chain_exact(csf.expanded_indices(), csf.values, fs, 0).numpy()
    lengths = csf.fiber_lengths()
    group_of = np.repeat(np.arange(len(lengths)), lengths) // 5
    want_c = np.zeros_like(c)
    want_l1 = np.zeros_like(l1)
    np.add.at(want_c, group_of, scaled)
    np.add.at(want_l1, group_of, np.abs(scaled))
    np.testing.assert_array_equal(c, want_c)
    np.testing.assert_array_equal(l1, want_l1)
    jc, jl1 = jabft._group_reference(sparse_case["jcsf"], sparse_case["jfs"], 0, groups)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(l1, jl1)


def test_abft_mttkrp_clears_transient_spikes_like_the_reference(cfg, sparse_case):
    plan = faults.FaultPlan(seed=7, adc_spikes=(faults.AdcSpike(magnitude=2.0, rate=0.01),))
    with jfaults.inject(_twin(plan)):
        jy, jrep = jfaults.abft_mttkrp(sparse_case["jcsf"], sparse_case["jfs"], n_arrays=1)
    with faults.inject(plan):
        y, rep = faults.abft_mttkrp(sparse_case["tcsf"], sparse_case["tfs"], config=cfg,
                                    n_arrays=1)
    assert _report(rep) == _report(jrep)
    assert rep.faulty and rep.recovered >= 1 and rep.recovery_cycles > 0
    jy = np.asarray(jy)
    assert np.abs(y.numpy() - jy).max() <= _one_code(jy)
    clean = sparse_case["clean"]
    assert np.max(np.abs(y.numpy() - clean)) / np.max(np.abs(clean)) <= rep.rel_tol


def test_abft_mttkrp_clean_run_is_untouched(cfg, sparse_case):
    y, rep = faults.abft_mttkrp(sparse_case["tcsf"], sparse_case["tfs"], config=cfg,
                                n_arrays=1)
    _, jrep = jfaults.abft_mttkrp(sparse_case["jcsf"], sparse_case["jfs"], n_arrays=1)
    assert _report(rep) == _report(jrep)
    assert not rep.faulty and rep.retries == 0
    np.testing.assert_array_equal(y.numpy(), sparse_case["clean"])
    assert np.abs(sparse_case["clean"] - sparse_case["jclean"]).max() \
        <= _one_code(sparse_case["jclean"])


def test_abft_mttkrp_small_groups_like_the_reference(cfg, sparse_case):
    """Groups of 3 root fibers see sparser spikes: the report equals the
    reference's and ``y`` lies within one code of it."""
    plan = faults.FaultPlan(seed=3, adc_spikes=(faults.AdcSpike(magnitude=2.0, rate=0.004),))
    with jfaults.inject(_twin(plan)):
        jy, jrep = jfaults.abft_mttkrp(sparse_case["jcsf"], sparse_case["jfs"], n_arrays=1,
                                       group_fibers=3)
    with faults.inject(plan):
        y, rep = faults.abft_mttkrp(sparse_case["tcsf"], sparse_case["tfs"], config=cfg,
                                    n_arrays=1, group_fibers=3)
    assert _report(rep) == _report(jrep)
    assert rep.faulty and rep.checked == -(-64 // 3)
    jy = np.asarray(jy)
    assert np.abs(y.numpy() - jy).max() <= _one_code(jy)


def test_abft_mttkrp_on_four_arrays(cfg, sparse_case):
    """The check drive on a 4-array mesh (which the reference runs only on
    four devices): clean, nothing detected and ``y`` bit-equal to the mesh
    call; spiked shards detected and corrected within ``rel_tol``, every
    detected group recovered or taken by the fallback."""
    csf, fs = sparse_case["tcsf"], sparse_case["tfs"]
    y, rep = faults.abft_mttkrp(csf, fs, config=cfg, n_arrays=4, group_fibers=3)
    assert not rep.faulty and torch.equal(y, mesh_stream_mttkrp(csf, fs, cfg, n_arrays=4))
    plan = faults.FaultPlan(seed=3, adc_spikes=(faults.AdcSpike(magnitude=2.0, rate=0.004),))
    with faults.inject(plan):
        y, rep = faults.abft_mttkrp(csf, fs, config=cfg, n_arrays=4, group_fibers=3)
    assert rep.faulty and rep.recovered + rep.fallbacks == len(rep.detected)
    clean = sparse_case["clean"]
    assert np.max(np.abs(y.numpy() - clean)) / np.max(np.abs(clean)) <= rep.rel_tol


# ------------------------------------------------------- zero false positives


MATMUL_SHAPES = [(4, 32, 64), (8, 64, 96), (3, 20, 40), (16, 100, 33)]


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_abft_matmul_no_false_positives(cfg, m, k, n, seed):
    """Pure quantization/ADC noise — no plan armed — never trips the
    threshold; the report is the reference's."""
    x, w = _operands(m, k, n, seed=seed, scale=10.0 ** (seed - 1))
    _, rep = faults.abft_matmul(torch.tensor(x), torch.tensor(w), cfg)
    assert not rep.faulty, (m, k, n, seed, rep.detected)
    _, jrep = jfaults.abft_matmul(jnp.asarray(x), jnp.asarray(w))
    assert _report(rep) == _report(jrep)


@pytest.mark.parametrize("seed", [0, 3, 9])
def test_abft_mttkrp_no_false_positives(cfg, seed):
    key = jax.random.PRNGKey(seed)
    shape = (30, 24, 18)
    jcoo = j_powerlaw_coo(key, shape, nnz=800, rank=4)
    fs = [np.asarray(jax.random.normal(jax.random.fold_in(key, i), (s, 16)))
          for i, s in enumerate(shape)]
    coo = convert.coo(np.asarray(jcoo.indices), np.asarray(jcoo.values), shape,
                      mode_order=jcoo.mode_order, device="cpu")
    _, rep = faults.abft_mttkrp(csf_for_mode(coo, 0), [torch.tensor(f) for f in fs],
                                config=cfg, n_arrays=1)
    assert not rep.faulty, rep.detected


if HAVE_HYPOTHESIS:
    @settings(max_examples=12, deadline=None)
    @given(seed=st.integers(0, 2**31 - 1),
           log_scale=st.floats(-2.0, 2.0),
           shape=st.sampled_from(MATMUL_SHAPES))
    def test_abft_matmul_no_false_positives_property(seed, log_scale, shape):
        cfg = backends.resolve_config(None)
        m, k, n = shape
        x, w = _operands(m, k, n, seed=seed, scale=10.0 ** log_scale)
        _, rep = faults.abft_matmul(torch.tensor(x), torch.tensor(w), cfg)
        assert not rep.faulty, (shape, seed, log_scale, rep.detected)
else:  # pragma: no cover - exercised only without hypothesis installed
    @pytest.mark.skip(reason="property tests need hypothesis")
    def test_abft_matmul_no_false_positives_property():
        ...


# ---------------------------------------------------------- degraded mode


def test_degraded_mesh_is_bit_identical(cfg, sparse_case):
    """Lose an array mid-plan, recover its fiber ranges on survivors: the
    result is bit-identical to a mesh that never failed, at one array and
    at four, and the report is the reference's."""
    csf, fs = sparse_case["tcsf"], sparse_case["tfs"]
    loss = faults.FaultPlan(seed=0, array_loss=(faults.ArrayLoss(2),))
    with faults.inject(loss):
        y, rep = faults.degraded_mesh_mttkrp(csf, fs, config=cfg, n_arrays=4)
    with jfaults.inject(_twin(loss)):
        _, jrep = jfaults.degraded_mesh_mttkrp(sparse_case["jcsf"], sparse_case["jfs"],
                                               n_arrays=4)
    np.testing.assert_array_equal(y.numpy(), sparse_case["clean"])
    assert torch.equal(y, mesh_stream_mttkrp(csf, fs, cfg, n_arrays=4))
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
    assert rep.dead == (2,) and rep.survivors == 3
    assert rep.recovered_rows > 0 and rep.recovery_cycles > 0
    assert 0 < rep.throughput_frac <= 1.0 and rep.throughput_frac == jrep.throughput_frac
    assert rep.degraded_makespan_cycles >= rep.healthy_makespan_cycles


def test_degraded_mesh_explicit_dead_and_guards(cfg, sparse_case):
    csf, fs = sparse_case["tcsf"], sparse_case["tfs"]
    y, rep = faults.degraded_mesh_mttkrp(csf, fs, config=cfg, n_arrays=4, dead_arrays=(0, 3))
    np.testing.assert_array_equal(y.numpy(), sparse_case["clean"])
    assert rep.dead == (0, 3) and rep.survivors == 2
    _, rep1 = faults.degraded_mesh_mttkrp(csf, fs, config=cfg, n_arrays=2, dead_arrays=(1, 7))
    assert rep1.dead == (1,)
    with pytest.raises(ValueError, match="nothing survives"):
        faults.degraded_mesh_mttkrp(csf, fs, config=cfg, n_arrays=2, dead_arrays=(0, 1))


def test_recover_dead_rows_leaves_its_input(cfg, sparse_case):
    """The splice is made on a copy: the partial output passed in keeps its
    zero rows."""
    from repro_torch.faults.degraded import recover_dead_rows
    from repro_torch.sparse import partition_csf

    csf, fs = sparse_case["tcsf"], sparse_case["tfs"]
    meshed = partition_csf(csf, n_arrays=4, rank=32, config=cfg, planner="makespan")
    partial = torch.zeros((64, 32))
    y, cycles = recover_dead_rows(partial, meshed, (1,), fs, cfg)
    assert bool((partial == 0).all()) and cycles > 0
    rows = np.unique(meshed.shards[1].fids[0])
    np.testing.assert_array_equal(y.numpy()[rows], sparse_case["clean"][rows])


# ----------------------------------------------------------- names and spans


def test_lazy_names_are_the_reference_names():
    assert faults.__all__ == jfaults.__all__
    assert set(faults._LAZY) == set(jfaults._LAZY)
    for name in faults.__all__:
        assert getattr(faults, name) is not None
    assert faults.abft_matmul is tabft.abft_matmul
    with pytest.raises(AttributeError, match="no attribute"):
        faults.not_a_fault_name


def test_fault_spans_and_counters_equal_the_reference(cfg, sparse_case):
    """ABFT on the matmul and the MTTKRP and a degraded run, traced in both
    packages: the ``fault/*`` span names and args and the counters equal."""
    for o in (obs, jobs):
        o.enable()
    x, w = _operands(8, 64, 96, seed=0)
    plan = faults.FaultPlan(seed=7, stuck_bits=(faults.StuckBit(rate=5e-3),))
    with faults.inject(plan):
        faults.abft_matmul(torch.tensor(x), torch.tensor(w), cfg)
    with jfaults.inject(_twin(plan)):
        jfaults.abft_matmul(jnp.asarray(x), jnp.asarray(w))
    spikes = faults.FaultPlan(seed=7, adc_spikes=(faults.AdcSpike(magnitude=2.0, rate=0.01),))
    with faults.inject(spikes):
        faults.abft_mttkrp(sparse_case["tcsf"], sparse_case["tfs"], config=cfg, n_arrays=1)
    with jfaults.inject(_twin(spikes)):
        jfaults.abft_mttkrp(sparse_case["jcsf"], sparse_case["jfs"], n_arrays=1)
    faults.degraded_mesh_mttkrp(sparse_case["tcsf"], sparse_case["tfs"], config=cfg,
                                n_arrays=4, dead_arrays=(1,))
    jfaults.degraded_mesh_mttkrp(sparse_case["jcsf"], sparse_case["jfs"], n_arrays=4,
                                 dead_arrays=(1,))

    def spans(o):
        return [(e["name"], {k: (v.item() if hasattr(v, "item") else v)
                             for k, v in e.get("args", {}).items()})
                for e in o.get_tracer().events()
                if e["ph"] == "X" and e["name"].startswith("fault/")]

    got, want = spans(obs), spans(jobs)
    assert got == want
    assert {"fault/inject/armed", "fault/abft/check", "fault/abft/redrive",
            "fault/abft/fallback", "fault/mesh/degraded", "fault/mesh/redrive"} \
        <= {n for n, _ in got}
    counters = obs.get_tracer().counters()
    jcounters = jobs.get_tracer().counters()
    keys = [k for k in jcounters if k.startswith("fault/")]
    assert {k: counters[k] for k in keys} == {k: jcounters[k] for k in keys}
    assert {"fault/detected", "fault/redrives", "fault/recovered", "fault/recovery_cycles",
            "fault/arrays_lost", "fault/recovered_rows"} <= set(keys)
