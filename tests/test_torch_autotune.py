"""``repro_torch.kernels.autotune`` held against the JAX package's
``repro.kernels.autotune`` on the CPU: the winner cache's by-value keys, the
heuristic fallback and its switch, the JSON round trip (and a table saved by
either package loaded by the other), the tolerance of damaged tables, the
``autotune/*`` spans, and sweeps over real operands through kernel 1's plain
version — every candidate ``exec_blocks`` within the fused family's envelope
of the reference's fused stream at the same chunk size.
"""
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs
from repro.core.psram import PsramConfig as JPsramConfig
from repro.kernels import autotune as jat
from repro.kernels import stream_mttkrp as jk
from repro.sparse import csf_for_mode as j_csf_for_mode
from repro.sparse import powerlaw_coo as j_powerlaw_coo
from repro_torch import backends, convert, obs
from repro_torch.core.psram import PsramConfig
from repro_torch.kernels import autotune as at
from repro_torch.kernels import stream_mttkrp as tk
from repro_torch.kernels.autotune import (
    TuneKey,
    cache_stats,
    clear_autotune_cache,
    get_params,
    heuristic,
    load_cache,
    nnz_profile,
    save_cache,
    stream_params,
)
from repro_torch.kernels.ops import fused_stream_mttkrp_op
from repro_torch.sparse import stream as tstream


@pytest.fixture(autouse=True)
def _fresh_caches():
    for mod in (at, jat):
        mod.clear_autotune_cache()
    for o in (obs, jobs):
        o.disable()
        o.get_tracer().clear()
    yield
    for mod in (at, jat):
        mod.clear_autotune_cache()
    for o in (obs, jobs):
        o.disable()
        o.get_tracer().clear()


def _key(nnz=5000, rank=8, config=PsramConfig, key=TuneKey):
    # two calls build equal-by-value but distinct objects (fresh PsramConfig)
    return key(kind="stream", shape=(40, 30, 20, rank),
               profile=nnz_profile(nnz, [5] * (nnz // 5)), config=config())


def _jkey(nnz=5000, rank=8):
    return _key(nnz, rank, JPsramConfig, jat.TuneKey)


def _fake_measure(calls, result=lambda: torch.zeros(())):
    """measure factory that records each sweep invocation."""
    def measure(params):
        calls.append(dict(params))
        return result
    return measure


def test_equal_by_value_keys_share_one_tuned_entry():
    calls = []
    won = get_params(_key(), measure=_fake_measure(calls), tune=True)
    assert calls, "tuning should have swept candidates"
    n_swept = len(calls)
    # an equal-by-value key (fresh objects throughout) hits the same entry:
    # no second sweep, identical winner
    again = get_params(_key(), measure=_fake_measure(calls), tune=True)
    assert again == won
    assert len(calls) == n_swept
    assert cache_stats()[0] == 1
    assert [t["params"] for t in at.sweep_log()[0]["trials"]] == calls


def test_distinct_keys_miss():
    calls = []
    get_params(_key(nnz=5000), measure=_fake_measure(calls), tune=True)
    first = len(calls)
    # a different nonzero scale buckets to a different profile -> new sweep
    get_params(_key(nnz=500_000), measure=_fake_measure(calls), tune=True)
    assert len(calls) > first
    assert cache_stats()[0] == 2


def test_heuristic_when_tuning_disabled(monkeypatch):
    calls = []
    # tune not requested: heuristic, nothing measured, nothing cached
    got = get_params(_key(), measure=_fake_measure(calls), tune=False)
    assert got == heuristic(_key())
    assert not calls and cache_stats()[0] == 0
    # the reference's switch leaves the port alone, and the port's its own
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    assert at.enabled() and not jat.enabled()
    monkeypatch.delenv("REPRO_AUTOTUNE")
    # REPRO_TORCH_AUTOTUNE=0 force-disables even an explicit tune=True
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "0")
    assert jat.enabled() and not at.enabled()
    got = get_params(_key(), measure=_fake_measure(calls), tune=True)
    assert got == heuristic(_key())
    assert not calls and cache_stats()[0] == 0


def test_heuristic_and_candidates_equal_the_reference():
    key = _key()
    assert heuristic(key) == heuristic(key)
    assert heuristic(key)["exec_blocks"] >= 1
    # the heuristic seeds the sweep, so an all-tie sweep keeps the default
    assert at.candidates(key)[0] == heuristic(key)
    for kind, (pk, jk_) in {
        "stream": (_key(), _jkey()),
        "matmul": (at.matmul_key(64, 128, 32, PsramConfig()),
                   jat.matmul_key(64, 128, 32, JPsramConfig())),
        "dense_mttkrp": (at.dense_mttkrp_key(8, 9, 10, 4, PsramConfig()),
                         jat.dense_mttkrp_key(8, 9, 10, 4, JPsramConfig())),
    }.items():
        assert pk.kind == kind and (pk.shape, pk.profile) == (jk_.shape, jk_.profile)
        assert at.heuristic(pk) == jat.heuristic(jk_)
        assert at.candidates(pk) == jat.candidates(jk_)
        assert at._key_token(pk) == jat._key_token(jk_)
    for rows in (16, 100, 256, 4096):
        assert at.candidates(_key(config=lambda: PsramConfig(rows=rows))) \
            == jat.candidates(_key(config=lambda: JPsramConfig(rows=rows), key=jat.TuneKey))
    with pytest.raises(ValueError, match="kind"):
        at.candidates(TuneKey("conv", (), (), PsramConfig()))


def test_save_load_round_trip(tmp_path):
    calls = []
    won = get_params(_key(), measure=_fake_measure(calls), tune=True)
    path = str(tmp_path / "tune.json")
    assert save_cache(path) == 1
    clear_autotune_cache()
    assert cache_stats()[0] == 0 and at.sweep_log() == ()
    assert load_cache(path) == 1
    # a loaded winner is installed lazily on first ask — no measure needed
    got = get_params(_key(), measure=None, tune=False)
    assert got == won
    assert cache_stats()[0] == 1


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_a_table_saved_by_either_package_loads_in_the_other(tmp_path, direction):
    """The key tokens are the reference's: a winner either package saves
    installs itself in the other for the equal key, with no sweep."""
    path = str(tmp_path / "tune.json")
    keys = [(_key(nnz), _jkey(nnz)) for nnz in (5000, 500_000)]
    winners = [{"exec_blocks": 64}, {"exec_blocks": 128}]
    src, dst = (jat, at) if direction == "reference_to_port" else (at, jat)
    for (pk, jk_), won in zip(keys, winners):
        src._WINNERS[jk_ if src is jat else pk] = won
    assert src.save_cache(path) == 2
    assert dst.load_cache(path) == 2
    for (pk, jk_), won in zip(keys, winners):
        assert dst.get_params(pk if dst is at else jk_, measure=None, tune=False) == won
    assert dst.cache_stats()[0] == 2


def test_load_cache_tolerates_corruption(tmp_path):
    """A damaged winner table is a warning, never an outage: the heuristic
    defaults stay in force and tuning still works afterwards."""
    for name, payload in (("garbage.json", b"\x00\xffnot json at all"),
                          ("truncated.json", b'{"stream|x": {"exec_b')):
        p = tmp_path / name
        p.write_bytes(payload)
        with pytest.warns(UserWarning, match="corrupt"):
            assert load_cache(str(p)) == 0
    # legal JSON of the wrong shape is rejected the same soft way
    wrong = tmp_path / "wrong.json"
    wrong.write_text("[1, 2, 3]")
    with pytest.warns(UserWarning, match="not a winner table"):
        assert load_cache(str(wrong)) == 0
    assert cache_stats()[0] == 0
    # the cache layer still functions: heuristic asks and real tuning work
    assert get_params(_key(), measure=None, tune=False) == heuristic(_key())
    calls = []
    get_params(_key(), measure=_fake_measure(calls), tune=True)
    assert calls and cache_stats()[0] == 1


def test_load_cache_drops_malformed_entries(tmp_path):
    """Partially damaged tables keep their good rows: a valid winner saved
    earlier survives a bad row spliced in next to it."""
    calls = []
    won = get_params(_key(), measure=_fake_measure(calls), tune=True)
    path = str(tmp_path / "tune.json")
    assert save_cache(path) == 1
    table = json.loads(open(path).read())
    table["bad-row"] = "not a params dict"
    with open(path, "w") as f:
        json.dump(table, f)
    clear_autotune_cache()
    with pytest.warns(UserWarning, match="dropped 1"):
        assert load_cache(path) == 1
    assert get_params(_key(), measure=None, tune=False) == won


def test_load_cache_missing_file_raises(tmp_path):
    # a wrong path is a caller bug, not damage — it must not be swallowed
    with pytest.raises(FileNotFoundError):
        load_cache(str(tmp_path / "nope.json"))


def test_clear_program_cache_clears_autotune():
    from repro_torch.core.schedule import clear_program_cache

    calls = []
    get_params(_key(), measure=_fake_measure(calls), tune=True)
    assert cache_stats()[0] == 1
    clear_program_cache()
    assert cache_stats()[0] == 0 and at.sweep_log() == ()


def _sleeper(params):
    """A runner whose time grows with the candidate's chunk (the smallest
    wins), for both packages."""
    def run():
        time.sleep(2e-4 * params["exec_blocks"] / 16)
        return 0
    return run


def test_spans_and_counters_equal_the_reference():
    """One sweep in each package under tracing: the ``autotune/*`` spans'
    names and args in order, ``median_s`` aside, and the trial counter."""
    for o in (obs, jobs):
        o.enable()
    won = get_params(_key(), measure=_sleeper, tune=True)
    jwon = jat.get_params(_jkey(), measure=_sleeper, tune=True)
    assert won == jwon == {"exec_blocks": 16}

    def spans(o):
        return [(e["name"], {k: v for k, v in e.get("args", {}).items() if k != "median_s"})
                for e in o.get_tracer().events() if e["ph"] == "X"]

    got, want = spans(obs), spans(jobs)
    assert got == want
    assert [n for n, _ in got].count("autotune/trial/run") == 3 * len(at.candidates(_key()))
    assert got[-1][0] == "autotune/winner" and got[-2][0] == "autotune/sweep"
    winner = [e for e in obs.get_tracer().events() if e["name"] == "autotune/winner"][0]
    assert winner["args"]["median_s"] == min(t["median_s"] for t in at.sweep_log()[0]["trials"])
    assert obs.get_tracer().counters() == jobs.get_tracer().counters() \
        == {"autotune/trials": len(at.candidates(_key()))}
    # a cache hit sweeps nothing and records nothing
    obs.get_tracer().clear()
    assert get_params(_key(), measure=_sleeper, tune=True) == won
    assert obs.get_tracer().counters() == {} and not obs.get_tracer().events()


# ------------------------------------------------- sweeps on real operands


def _reference_pair(shape=(30, 24, 18), nnz=600, rank=6, mode=0, seed_key=3):
    coo = j_powerlaw_coo(jax.random.PRNGKey(seed_key), shape, nnz=nnz, rank=4, alpha=1.1)
    jcsf = j_csf_for_mode(coo, mode)
    rng = np.random.default_rng(seed_key)
    fs = [rng.standard_normal((s, rank)).astype(np.float32) for s in shape]
    tcsf = convert.csf(jcsf.shape, jcsf.mode_order, jcsf.fids, jcsf.fptr,
                       np.asarray(jcsf.values), device="cpu")
    return (jcsf, tuple(jnp.asarray(f) for f in fs)), (tcsf, tuple(torch.tensor(f) for f in fs))


def test_stream_params_tunes_on_real_operands():
    """End to end on a small CSF: tuning sweeps the plain version of kernel 1
    on the real layout, caches one winner and remembers it; the tuned run is
    the untuned one at the winner's chunk, bit for bit, and within 1e-3 of
    the heuristic's; the ``hopper`` backend with ``autotune=True`` runs the
    winner, and two equal workloads share it."""
    _, (csf, fs) = _reference_pair()
    cfg = PsramConfig()
    params = stream_params(csf, fs, cfg, tune=True)
    assert params["exec_blocks"] >= 1
    assert cache_stats()[0] == 1
    (sweep,) = at.sweep_log()
    assert [t["params"] for t in sweep["trials"]] == at.candidates(sweep["key"])
    assert all(t["route"] == "torch" and t["median_s"] > 0 for t in sweep["trials"])
    assert sweep["winner"] == params
    # the winner is remembered: a second ask is a pure cache hit
    assert stream_params(csf, fs, cfg, tune=True) == params
    assert cache_stats()[0] == 1 and len(at.sweep_log()) == 1
    tuned = fused_stream_mttkrp_op(csf, fs, cfg, autotune=True)
    at_winner = fused_stream_mttkrp_op(csf, fs, cfg, exec_blocks=params["exec_blocks"])
    assert torch.equal(tuned, at_winner)
    untuned = fused_stream_mttkrp_op(csf, fs, cfg)
    rel = float(torch.linalg.norm(tuned - untuned) / torch.linalg.norm(untuned))
    assert rel < 1e-3
    be = backends.get("hopper", autotune=True)
    assert be.capabilities().autotune
    assert torch.equal(be.mttkrp(csf, fs, 0), tuned)
    assert len(at.sweep_log()) == 1


def _row_tolerance(sp, adc_bits, parts_max, out_rows):
    """Per output row: one ADC code of the chunk's full scale for every
    (chunk, slot) that maps to the row."""
    sp = np.asarray(sp)
    lsb = 2.0 * np.maximum(parts_max, 1e-30) / 2 ** adc_bits
    tol = np.zeros(out_rows + 1)
    np.add.at(tol, sp.reshape(-1), np.repeat(lsb, sp.shape[1]))
    return tol[:out_rows]


@pytest.mark.parametrize("mode", [0, 2])
def test_every_candidate_within_the_envelope_of_the_reference(mode):
    """At ``rows=16`` the candidates cut a 12k-nonzero stream into 1 to 3
    chunks: at each, the port's fused stream (the plain version) is within
    one ADC code of its chunk's full scale per partial of the reference's
    fused stream at the same ``exec_blocks``; the chunk sizes move the
    result (the ADC ranges differ), within the envelope of exact."""
    (jcsf, jfs), (tcsf, tfs) = _reference_pair(shape=(60, 50, 40), nnz=12000, rank=8,
                                               mode=mode, seed_key=5)
    cfg, jcfg = PsramConfig(rows=16), JPsramConfig(rows=16)
    key = at.stream_key(tcsf, 8, cfg)
    cands = [p["exec_blocks"] for p in at.candidates(key)]
    assert cands == [p["exec_blocks"] for p in jat.candidates(jat.stream_key(jcsf, 8, jcfg))]
    out_rows = tcsf.shape[mode]
    outs = []
    for eb in cands:
        got = tk.fused_stream_mttkrp(tcsf, tfs, cfg, lowering="torch", exec_blocks=eb)
        want = np.asarray(jk.fused_stream_mttkrp(jcsf, jfs, jcfg, exec_blocks=eb))
        ip, vp, lp, sp, n_seg = tstream.stream_layout(tcsf, cfg.rows, eb)
        qs, ss = tk.stream_factor_quants(tfs, mode)
        _, chunk_max = tk.stream_mttkrp_fused_torch(ip, vp, lp, sp, qs, ss, mode, n_seg, 16,
                                                    out_rows, return_chunk_max=True)
        tol = _row_tolerance(sp, 16, chunk_max.numpy(), out_rows)
        bound = tol[:, None] + 1e-6 * np.abs(want) + 1e-6 * np.abs(want).max()
        assert (np.abs(got.numpy() - want) <= bound).all(), eb
        outs.append(got)
    assert any(not torch.equal(outs[0], o) for o in outs[1:])
    exact = backends.get("exact").mttkrp(tcsf, tfs, mode)
    for o in outs:
        assert float(torch.linalg.norm(o - exact) / torch.linalg.norm(exact)) < 0.05
