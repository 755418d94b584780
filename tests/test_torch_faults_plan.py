"""``repro_torch.faults.plan`` held against the JAX package's
``repro.faults.plan`` on the CPU: the fault models' validation, the scoped,
seeded and replayable injection runtime (nesting, ``suspended``, epochs),
its ``fault/*`` span and counter, and the three corruption transforms —
each output **equal** to the reference's for the same plan and input, since
both draw their sites from the same seeded numpy streams.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import faults as jfaults
from repro import obs as jobs
from repro.faults import plan as jplan
from repro_torch import faults, obs
from repro_torch.core.quantization import WORD_BITS
from repro_torch.faults import plan as plan_mod


@pytest.fixture(autouse=True)
def _clean_tracers():
    for o in (obs, jobs):
        o.disable()
        o.get_tracer().clear()
    yield
    for o in (obs, jobs):
        o.disable()
        o.get_tracer().clear()


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


# -------------------------------------------------------------- validation


@pytest.mark.parametrize("fault", [
    faults.StuckBit(bit=WORD_BITS),          # outside the word
    faults.StuckBit(bit=-1),
    faults.StuckBit(value=2),
    faults.StuckBit(rate=1.5),
    faults.AdcSpike(magnitude=0.0),          # a zero spike is not a fault
    faults.AdcSpike(rate=-0.1),
    faults.DeadChannel(channels=()),
    faults.DeadChannel(channels=(3, -1)),
    faults.LaserDrift(gain=1.0),             # gain 1 is not drift
    faults.LaserDrift(gain=0.0),
    faults.ArrayLoss(array_id=-2),
], ids=lambda f: repr(f))
def test_fault_model_validation(fault):
    with pytest.raises(ValueError) as got:
        fault.validate()
    twin = getattr(jfaults, type(fault).__name__)(**dataclasses.asdict(fault))
    with pytest.raises(ValueError) as want:
        twin.validate()
    assert str(got.value) == str(want.value)


def test_plan_validation_cascades_and_arming_checks():
    bad = faults.FaultPlan(stuck_bits=(faults.StuckBit(bit=WORD_BITS),))
    with pytest.raises(ValueError, match="bit"):
        with faults.inject(bad):
            pass
    assert plan_mod.active() is None
    # properties on a healthy plan
    p = faults.FaultPlan(array_loss=(faults.ArrayLoss(2), faults.ArrayLoss(0)))
    assert p.dead_arrays == frozenset({0, 2}) == _twin(p).dead_arrays
    assert not p.touches_array_path          # array loss is mesh-level only
    assert faults.FaultPlan(stuck_bits=(faults.StuckBit(),)).touches_array_path
    assert dataclasses.asdict(faults.FaultPlan()) == dataclasses.asdict(jfaults.FaultPlan())


# ------------------------------------------------------- injection runtime


def test_inject_is_scoped_seeded_and_replayable():
    """The same plan corrupts the same sites every time it is armed, equal
    to the reference's; another seed corrupts others; disarmed, nothing."""
    plan = faults.FaultPlan(seed=11, adc_spikes=(faults.AdcSpike(rate=0.05),))
    vp = np.ones((3, 4, 16), np.float32)
    with faults.inject(plan):
        assert plan_mod.active() is plan
        a = plan_mod.corrupt_shard_values(plan, vp)
    with faults.inject(plan):
        b = plan_mod.corrupt_shard_values(plan, torch.tensor(vp))
    assert np.array_equal(a, b) and not np.array_equal(a, vp)
    with faults.inject(dataclasses.replace(plan, seed=12)):
        c = plan_mod.corrupt_shard_values(dataclasses.replace(plan, seed=12), vp)
    assert not np.array_equal(a, c)
    with jfaults.inject(_twin(plan)):
        want = jplan.corrupt_shard_values(_twin(plan), vp)
    np.testing.assert_array_equal(a, want)
    assert plan_mod.active() is None and plan_mod.epoch() == 0


def test_inject_rejects_nesting_and_clears_on_exception():
    plan = faults.FaultPlan(stuck_bits=(faults.StuckBit(),))
    with faults.inject(plan):
        with pytest.raises(RuntimeError, match="already armed"):
            with faults.inject(plan):
                pass
        assert plan_mod.active() is plan     # outer plan survived the raise
        assert jplan.active() is None        # the packages' plans are their own
    with pytest.raises(KeyError):
        with faults.inject(plan):
            raise KeyError("boom")
    assert plan_mod.active() is None
    assert plan_mod.epoch() == 0


def test_suspended_disarms_and_restores():
    plan = faults.FaultPlan(adc_spikes=(faults.AdcSpike(),))
    with faults.inject(plan):
        with faults.suspended():
            assert plan_mod.active() is None
        assert plan_mod.active() is plan


def test_epoch_rerolls_transients_only():
    plan = faults.FaultPlan(seed=3, adc_spikes=(
        faults.AdcSpike(rate=0.05, transient=True),
        faults.AdcSpike(rate=0.05, transient=False),
    ))
    acc = np.zeros((4, 16), np.float32)
    with faults.inject(plan):
        e0 = plan_mod.corrupt_analog(plan, acc, 100.0, channel_axis=0)
        assert plan_mod.bump_epoch() == 1 and plan_mod.epoch() == 1
        e1 = plan_mod.corrupt_analog(plan, acc, 100.0, channel_axis=0)
    assert not np.array_equal(e0, e1)        # transient sites re-rolled
    with jfaults.inject(_twin(plan)):
        w0 = jplan.corrupt_analog(_twin(plan), acc, 100.0, channel_axis=0)
        jplan.bump_epoch()
        w1 = jplan.corrupt_analog(_twin(plan), acc, 100.0, channel_axis=0)
    np.testing.assert_array_equal(e0, w0)
    np.testing.assert_array_equal(e1, w1)
    only_persistent = dataclasses.replace(plan, adc_spikes=plan.adc_spikes[1:])
    with faults.inject(only_persistent):
        p0 = plan_mod.corrupt_analog(only_persistent, acc, 100.0, 0)
        plan_mod.bump_epoch()
        p1 = plan_mod.corrupt_analog(only_persistent, acc, 100.0, 0)
    assert np.array_equal(p0, p1)            # persistent sites recur


def test_fault_span_and_counter_equal_the_reference():
    for o in (obs, jobs):
        o.enable()
    plan = faults.FaultPlan(seed=7, stuck_bits=(faults.StuckBit(),),
                            array_loss=(faults.ArrayLoss(1),))
    with faults.inject(plan):
        pass
    with jfaults.inject(_twin(plan)):
        pass

    def spans(o):
        return [(e["name"], e.get("args")) for e in o.get_tracer().events() if e["ph"] == "X"]

    assert spans(obs) == spans(jobs) == [("fault/inject/armed", {
        "seed": 7, "stuck": 1, "spikes": 0, "dead_channels": 0, "arrays_lost": 1})]
    assert obs.get_tracer().counters() == jobs.get_tracer().counters() \
        == {"fault/injected": 1}


# --------------------------------------------------- corruption transforms


def test_corrupt_stored_bit_semantics():
    plan1 = faults.FaultPlan(stuck_bits=(faults.StuckBit(bit=2, value=1, rate=1.0),))
    q = np.array([[0, 1, -5, 100, -127]], np.int8)
    mag = np.abs(q.astype(np.int32))
    out = plan_mod.corrupt_stored(plan1, q)
    assert out.dtype == np.int32             # widened: MSB can leave int8
    # stuck-at-1 on bit 2 ORs the magnitude plane, sign rail untouched
    assert np.array_equal(np.abs(out), mag | 4)
    assert np.array_equal(np.sign(out)[np.asarray(q) < 0], [-1, -1])
    plan0 = faults.FaultPlan(stuck_bits=(faults.StuckBit(bit=0, value=0, rate=1.0),))
    out0 = plan_mod.corrupt_stored(plan0, torch.tensor(q))
    assert np.array_equal(np.abs(out0), mag & ~1)
    # rate 0: sites never fire, values pass through
    none = faults.FaultPlan(stuck_bits=(faults.StuckBit(rate=0.0),))
    assert np.array_equal(plan_mod.corrupt_stored(none, q), q.astype(np.int32))
    for p in (plan1, plan0, none):
        np.testing.assert_array_equal(plan_mod.corrupt_stored(p, q),
                                      np.asarray(jplan.corrupt_stored(_twin(p), q)))


@pytest.mark.parametrize("seed", [0, 5, 2 ** 40 + 3])
def test_corrupt_stored_seeded_sites_equal_the_reference(seed):
    rng = np.random.default_rng(seed % 97)
    q = rng.integers(-127, 128, size=(7, 32, 33)).astype(np.int8)
    plan = faults.FaultPlan(seed=seed, stuck_bits=(
        faults.StuckBit(bit=WORD_BITS - 1, value=1, rate=0.01),
        faults.StuckBit(bit=3, value=0, rate=0.2)))
    got = plan_mod.corrupt_stored(plan, torch.tensor(q))
    np.testing.assert_array_equal(got, np.asarray(jplan.corrupt_stored(_twin(plan), q)))
    assert (got != q).any()


def test_corrupt_analog_channels_and_drift():
    plan = faults.FaultPlan(dead_channels=(faults.DeadChannel((1, 3)),),
                            laser_drift=faults.LaserDrift(gain=0.5))
    acc = np.ones((2, 4, 5), np.float32)
    out = plan_mod.corrupt_analog(plan, acc, 10.0, channel_axis=1)
    assert np.all(out[:, (1, 3)] == 0.0)     # dead comb lines read zero
    assert np.all(out[:, (0, 2)] == 0.5)     # drift gain on the survivors
    np.testing.assert_array_equal(out, jplan.corrupt_analog(_twin(plan), acc, 10.0, 1))
    # channel indices past the comb width are ignored, not an error
    wide = faults.FaultPlan(dead_channels=(faults.DeadChannel((99,)),))
    assert np.array_equal(plan_mod.corrupt_analog(wide, acc, 10.0, 1), acc)
    spiked = faults.FaultPlan(seed=9, adc_spikes=(faults.AdcSpike(rate=0.2, magnitude=-0.5),),
                              laser_drift=faults.LaserDrift(gain=1.25))
    acc2 = np.random.default_rng(1).standard_normal((6, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(plan_mod.corrupt_analog(spiked, torch.tensor(acc2), 3.0, 1),
                                  jplan.corrupt_analog(_twin(spiked), acc2, 3.0, 1))


def test_corrupt_shard_values_copies_and_kills_arrays():
    plan = faults.FaultPlan(seed=5, array_loss=(faults.ArrayLoss(1),),
                            adc_spikes=(faults.AdcSpike(rate=0.1, magnitude=2.0),))
    vp = np.ones((3, 20), np.float32)
    before = vp.copy()
    out = plan_mod.corrupt_shard_values(plan, vp)
    assert np.array_equal(vp, before)        # cached layouts stay pristine
    assert np.all(out[1] == 0.0)             # the dead shard contributes 0
    assert (out[[0, 2]] != 1.0).any()        # survivors took seeded spikes
    np.testing.assert_array_equal(out, jplan.corrupt_shard_values(_twin(plan), vp))
    t = torch.ones(3, 20)
    assert np.array_equal(plan_mod.corrupt_shard_values(plan, t), out)
    assert torch.equal(t, torch.ones(3, 20))
    # a dead array past the stack is ignored; array_axis picks the axis
    far = faults.FaultPlan(array_loss=(faults.ArrayLoss(7),))
    assert np.array_equal(plan_mod.corrupt_shard_values(far, vp), vp)
    axis1 = faults.FaultPlan(seed=2, array_loss=(faults.ArrayLoss(0),),
                             adc_spikes=(faults.AdcSpike(rate=0.3),))
    vq = np.random.default_rng(4).standard_normal((5, 4, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        plan_mod.corrupt_shard_values(axis1, vq, array_axis=1),
        jplan.corrupt_shard_values(_twin(axis1), vq, array_axis=1))
