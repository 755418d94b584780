"""The array model of the port held against the JAX reference on the CPU:
``PsramArray``, the tile-schedule IR and its program cache, the vectorized
executor and the per-cycle oracle, the compiled executor, the accountant,
the §IV primitives.

Everything here is **bit-equal** to the reference on the same inputs (numpy
arrays from a seed): the reference's executor and oracle run eagerly, one
true division per quotient, and so does the port. The counts are equal
field for field. The JAX calls compile op by op on first use, a few seconds
each, so the cases are few and small.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import perf_model as jpm
from repro.core import primitives as jprim
from repro.core import psram as jp
from repro.core import schedule as js
from repro.core.quantization import ADCConfig as JADCConfig
from repro.sparse import stream as jstream
from repro.sparse import synth as jsynth
from repro_torch.core import perf_model as tpm
from repro_torch.core import primitives as tprim
from repro_torch.core import psram as tp
from repro_torch.core import schedule as ts
from repro_torch.core.quantization import ADCConfig
from repro_torch.sparse import stream as tstream

SMALL = dict(rows=16, word_cols=8, wavelengths=4)


def _cfgs(adc_bits=16, saturate=True, **geometry):
    """The same array config in both packages."""
    return (jp.PsramConfig(**geometry, adc=JADCConfig(adc_bits, saturate)),
            tp.PsramConfig(**geometry, adc=ADCConfig(adc_bits, saturate)))


def _operands(shape_x, shape_w, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_x).astype(np.float32),
            rng.standard_normal(shape_w).astype(np.float32))


def _fields(obj):
    """A dataclass as a dict, for field-for-field equality across packages."""
    return dataclasses.asdict(obj)


# ---------------------------------------------------------------- PsramArray

@pytest.mark.parametrize("shape", [(16, 8), (10, 5), (1, 1)], ids=["full", "partial", "one"])
def test_array_store_bit_equal_to_the_reference(shape):
    """``store`` quantizes per column into sign + bit-planes: every plane,
    sign, scale, signed word and read-back value equal to the reference's."""
    w, _ = _operands(shape, (1, 1), seed=sum(shape))
    jcfg, tcfg = _cfgs(**SMALL)
    ref = jp.PsramArray(jcfg).store(jnp.asarray(w))
    got = tp.PsramArray(tcfg, device="cpu").store(torch.tensor(w))
    for name in ("sign", "planes", "scale"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    np.testing.assert_array_equal(got._signed_words().numpy(), np.asarray(ref._signed_words()))
    np.testing.assert_array_equal(got.stored_values().numpy(), np.asarray(ref.stored_values()))
    back = got.stored_values()[: shape[0], : shape[1]].numpy()
    assert np.abs(back - w).max() <= np.abs(w).max() / 127 + 1e-6
    with pytest.raises(ValueError, match="exceeds array"):
        tp.PsramArray(tcfg, device="cpu").store(torch.zeros(17, 8))


@pytest.mark.parametrize("drive", ["distinct", "shared", "mixed", "wdm", "wdm_partial"])
@pytest.mark.parametrize("adc_bits,saturate", [(16, True), (4, False)])
def test_array_drive_bit_equal_to_the_reference(drive, adc_bits, saturate):
    """Both drive modes of ``multiply_accumulate`` — per-row channels (each
    row its own, all on one, a mix) and WDM batching (every channel, a
    subset in a shuffled order) — bit-equal to the reference's."""
    geometry = dict(rows=8, word_cols=4, wavelengths=6)
    jcfg, tcfg = _cfgs(adc_bits, saturate, **geometry)
    w, x = _operands((8, 4), (6, 8), seed=3)
    chans = {"distinct": np.arange(8) % 6, "shared": np.zeros(8), "mixed": np.array(
        [0, 1, 0, 5, 1, 2, 2, 0]), "wdm": np.arange(6), "wdm_partial": np.array([4, 0, 2])}[drive]
    chans = chans.astype(np.int32)
    xs = x if drive.startswith("wdm") else x[0]
    xs = xs[: len(chans)] if drive == "wdm_partial" else xs
    ref = jp.PsramArray(jcfg).store(jnp.asarray(w)).multiply_accumulate(
        jnp.asarray(xs), jnp.asarray(chans))
    got = tp.PsramArray(tcfg, device="cpu").store(torch.tensor(w)).multiply_accumulate(
        torch.tensor(xs), torch.tensor(chans))
    assert got.shape == (4, 6) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_array_wavelength_separation():
    """Rows on different channels do not sum together (Fig. 2); rows on
    one channel add on the bit-line; a WDM batch is B separate cycles."""
    cfg = tp.PsramConfig(rows=4, word_cols=2, wavelengths=4)
    arr = tp.PsramArray(cfg, device="cpu").store(torch.ones(4, 2))
    x = torch.tensor([1.0, 2.0, 3.0, 4.0])
    per_row = arr.multiply_accumulate(x, torch.arange(4))
    np.testing.assert_allclose(per_row[0].numpy(), [1, 2, 3, 4], rtol=0.02)
    summed = arr.multiply_accumulate(x, torch.zeros(4, dtype=torch.int64))
    np.testing.assert_allclose(float(summed[0, 0]), 10.0, rtol=0.02)
    batch = torch.stack([x, 2 * x])
    wdm = arr.multiply_accumulate(batch, torch.tensor([3, 1]))
    for b, chan in enumerate([3, 1]):
        single = arr.multiply_accumulate(batch[b:b + 1], torch.tensor([chan]))
        assert torch.equal(wdm[:, chan], single[:, chan])


@pytest.mark.parametrize("xs,chans", [
    ([1.0, 2.0, 3.0, 4.0], [0, 1, 2, 3]),         # per row: 2 and 3 out of range
    ([1.0, 2.0, 3.0, 4.0], [-1, 0, 1, 1]),        # per row: negative
    ([[1.0] * 4] * 3, [0, 1, 0]),                 # WDM: more vectors than channels
    ([[1.0] * 4] * 2, [1, 1]),                    # WDM: a channel twice
    ([[1.0] * 4] * 2, [0, 2]),                    # WDM: a channel out of range
], ids=["row_high", "row_negative", "wdm_too_many", "wdm_duplicate", "wdm_high"])
def test_array_refuses_bad_channels_as_the_reference(xs, chans):
    """Out-of-range and malformed channels raise ``ValueError`` in both
    packages; the port checks a host copy of the channels on every call."""
    geometry = dict(rows=4, word_cols=2, wavelengths=2)
    jcfg, tcfg = _cfgs(**geometry)
    with pytest.raises(ValueError):
        jp.PsramArray(jcfg).store(jnp.ones((4, 2))).multiply_accumulate(
            jnp.asarray(xs), jnp.asarray(chans, jnp.int32))
    with pytest.raises(ValueError):
        tp.PsramArray(tcfg, device="cpu").store(torch.ones(4, 2)).multiply_accumulate(
            torch.tensor(xs), torch.tensor(chans))


# ------------------------------------------------------------------ the IR

@pytest.mark.parametrize("m,k,n,geometry", [
    (5, 40, 17, SMALL), (4, 16, 8, SMALL), (1, 1, 1, SMALL), (60, 300, 45, {}),
    (104, 1024, 2048, {}),
])
def test_matmul_programs_and_counts_equal_to_the_reference(m, k, n, geometry):
    """The canonical store/drive nest, op for op, and its counted cycles and
    energy, field for field."""
    jcfg, tcfg = _cfgs(**geometry)
    ref = js.build_matmul_program(m, k, n, jcfg)
    got = ts.build_matmul_program(m, k, n, tcfg)
    assert got.shape == ref.shape and got.repeats == ref.repeats and got.executable
    assert [(type(op).__name__, _fields(op)) for op in got.ops] \
        == [(type(op).__name__, _fields(op)) for op in ref.ops]
    assert _fields(ts.count_cycles(got)) == _fields(js.count_cycles(ref))
    assert _fields(ts.program_energy(got)) == _fields(js.program_energy(ref))
    spec = dict(write_pj_per_bit=2.08, laser_wall_w=3.0)
    assert _fields(ts.program_energy(got, tpm.EnergySpec(**spec))) \
        == _fields(js.program_energy(ref, jpm.EnergySpec(**spec)))
    assert ts.count_cycles(got).macs == m * k * n


@pytest.mark.parametrize("wl", [dict(), dict(rank=200), dict(i=100, j=100, k=100),
                                dict(i=1000, j=50, k=7, rank=5, nnz=4000)],
                         ids=["paper", "rank200", "small", "sparse_nnz"])
def test_mttkrp_programs_equal_to_the_reference(wl):
    jcfg, tcfg = _cfgs()
    ref = js.build_mttkrp_program(jcfg, jpm.MTTKRPWorkload(**wl))
    got = ts.build_mttkrp_program(tcfg, tpm.MTTKRPWorkload(**wl))
    assert got.repeats == ref.repeats and got.shape is None and not got.executable
    assert [_fields(op) for op in got.ops] == [_fields(op) for op in ref.ops]
    assert _fields(ts.count_cycles(got)) == _fields(js.count_cycles(ref))
    assert _fields(ts.program_energy(got)) == _fields(js.program_energy(ref))
    a = ts.count_cycles(got)
    assert _fields(a + a) == _fields(js.count_cycles(ref) + js.count_cycles(ref))


@pytest.mark.parametrize("rank,geometry", [(32, {}), (40, {}), (5, SMALL), (17, SMALL)])
def test_stream_programs_equal_to_the_reference(rank, geometry):
    """The streaming schedule of a power-law fiber distribution (and of an
    empty one): ops, block layout, rank-tile widths, counts and energy."""
    jcfg, tcfg = _cfgs(**geometry)
    fibers = jsynth.powerlaw_fiber_lengths(3, 500, 6000, alpha=1.2)
    for f in (fibers, np.zeros(0, np.int64), np.array([0, 3, 0, 700])):
        ref = jstream.build_stream_program(f, rank, jcfg)
        got = tstream.build_stream_program(f, rank, tcfg)
        assert [(type(op).__name__, _fields(op)) for op in got.ops] \
            == [(type(op).__name__, _fields(op)) for op in ref.ops]
        assert _fields(ts.count_cycles(got)) == _fields(js.count_cycles(ref))
        assert _fields(ts.program_energy(got)) == _fields(js.program_energy(ref))
        for a, b in zip(ts.stream_block_layout(f, tcfg.rows), js.stream_block_layout(f, jcfg.rows)):
            np.testing.assert_array_equal(a, b)
    assert tstream.rank_tile_widths(rank, tcfg.word_cols) \
        == jstream.rank_tile_widths(rank, jcfg.word_cols)
    with pytest.raises(ValueError):
        tstream.rank_tile_widths(0, 8)


def test_program_cache_keys_by_value():
    """Equal configs share one program object and one compiled executor;
    any changed field misses; ``clear_program_cache`` empties the program
    cache, gives new executors and clears the kernel family's keyed caches."""
    from repro_torch.kernels import ops, stream_mttkrp

    ts.clear_program_cache()
    c1 = tp.PsramConfig(rows=32, word_cols=8, wavelengths=8)
    c2 = tp.PsramConfig(rows=32, word_cols=8, wavelengths=8)
    assert c1 is not c2 and c1 == c2
    p1 = ts.build_matmul_program(40, 70, 20, c1)
    assert ts.build_matmul_program(40, 70, 20, c2) is p1
    stats = ts.program_cache_stats()
    assert (stats.hits, stats.misses, stats.currsize) == (1, 1, 1)
    for changed in (dataclasses.replace(c1, wavelengths=4), dataclasses.replace(c1, rows=16),
                    dataclasses.replace(c1, adc=ADCConfig(bits=8))):
        p2 = ts.build_matmul_program(40, 70, 20, changed)
        assert p2 is not p1 and p2.config != p1.config
    assert ts.build_matmul_program(40, 70, 21, c1) is not p1
    assert ts.program_cache_stats().currsize == 5
    e1 = ts.compiled_matmul_executor(24, 40, 16, c1)
    assert ts.compiled_matmul_executor(24, 40, 16, c2) is e1
    assert ts.compiled_matmul_executor(24, 40, 16, dataclasses.replace(c1, wavelengths=4)) \
        is not e1
    ops._STORE_CACHE[("probe",)] = None
    stream_mttkrp._FACTOR_QUANT_CACHE[("probe",)] = None
    ts.clear_program_cache()
    assert ts.program_cache_stats().currsize == 0
    assert ts.compiled_matmul_executor(24, 40, 16, c1) is not e1
    assert not ops._STORE_CACHE and not stream_mttkrp._FACTOR_QUANT_CACHE
    ts.clear_program_cache()


class _StubGraph:
    def __init__(self):
        self.reset_calls = 0

    def reset(self):
        self.reset_calls += 1


@pytest.mark.parametrize("budget,kept", [(0, ["c"]), (250, ["b", "c"]), (10 ** 9, ["a", "b", "c"])])
def test_captured_graphs_stay_within_their_byte_budget(budget, kept, monkeypatch):
    """The compiled executors' graphs share one byte budget a device: past
    it the least recently replayed are released (reset, forgotten), the
    newest always stays, and ``clear_program_cache`` releases the rest."""
    ts.clear_program_cache()
    monkeypatch.setattr(ts, "_GRAPH_BYTES", budget)
    dev = torch.device("cuda", 0)
    executors, graphs = {}, {}
    for name, nbytes in (("a", 100), ("b", 100), ("c", 100)):
        ex = ts._GraphedExecutor(None, (len(name), 1, 1))
        graphs[name] = _StubGraph()
        ex._graphs[dev] = (graphs[name], None, None, None)
        ts._CAPTURED[(ex, dev)] = nbytes
        executors[name] = ex
    ts._CAPTURED.move_to_end((executors["a"], dev))      # a replayed after b
    ts._CAPTURED.move_to_end((executors["b"], dev))      # then b, then c captured last
    ts._CAPTURED.move_to_end((executors["c"], dev))
    ts._evict(dev, keep=executors["c"])
    assert [k for k in "abc" if executors[k]._graphs] == kept
    assert [graphs[k].reset_calls for k in "abc"] == [int(k not in kept) for k in "abc"]
    assert sum(n for _, _, n in ts.captured_graphs()) == 100 * len(kept)
    ts.clear_program_cache()
    assert ts.captured_graphs() == [] and all(g.reset_calls == 1 for g in graphs.values())


def test_execute_validates_programs_as_the_reference():
    cfg = tp.PsramConfig(rows=32, word_cols=8, wavelengths=8)
    prog = ts.build_matmul_program(24, 40, 16, cfg)
    xn, wn = _operands((24, 40), (40, 16), seed=0)
    x, w = torch.tensor(xn), torch.tensor(wn)
    with pytest.raises(ValueError, match="accounting-only"):
        ts.execute(ts.build_mttkrp_program(tp.PsramConfig(), tpm.MTTKRPWorkload()), x, w)
    with pytest.raises(ValueError, match="repeats"):
        ts.execute(dataclasses.replace(prog, repeats=2), x, w)
    with pytest.raises(ValueError, match="don't match"):
        ts.execute(prog, x, w[:, :4])
    with pytest.raises(ValueError, match="don't match"):
        ts.execute_reference(prog, x[:3], w)
    clone = ts.TileProgram(config=cfg, ops=tuple(list(prog.ops)), shape=prog.shape)
    assert clone.ops is not prog.ops
    assert torch.equal(ts.execute(clone, x, w), ts.execute(prog, x, w))
    with pytest.raises(ValueError, match="non-canonical"):
        ts.execute(ts.TileProgram(config=cfg, ops=tuple(reversed(prog.ops)), shape=prog.shape),
                   x, w)
    ops = list(prog.ops)
    i = next(i for i, op in enumerate(ops) if isinstance(op, ts.Drive))
    ops[i] = dataclasses.replace(ops[i], m0=ops[i].m0 + 1, m1=ops[i].m1 + 1)
    with pytest.raises(ValueError, match="non-canonical"):
        ts.execute(ts.TileProgram(config=cfg, ops=tuple(ops), shape=prog.shape), x, w)
    with pytest.raises(ValueError, match="degenerate"):
        ts.build_matmul_program(0, 4, 4, cfg)


# -------------------------------------------------------------- executors

@pytest.mark.parametrize("m,k,n,adc_bits,saturate,geometry", [
    (3, 20, 5, 16, True, SMALL),              # everything ragged
    (13, 70, 23, 8, True, SMALL),             # multi-chunk everywhere
    (7, 33, 9, 4, False, SMALL),              # ADC 4 wraps past full scale
    (2, 40, 17, 16, False, SMALL),            # M < wavelengths, multi k-tile
    (40, 300, 45, 16, True, {}),              # the paper's array, ragged K, N, M
    (5, 1200, 6, 12, True, dict(rows=1100, word_cols=4, wavelengths=3)),  # past 2^24
])
def test_executor_and_oracle_bit_equal_to_the_reference(m, k, n, adc_bits, saturate, geometry):
    """The vectorized executor and the per-cycle oracle, each bit-equal to
    the reference's on the same inputs and to each other; ``compiled=True``
    on the CPU is the eager executor (within the reference's ~1e-7 envelope
    of its eager executor, here bit-equal); ``matmul_via_array`` is the
    executor. The last case's ``QMAX^2 * rows`` passes 2^24: the contraction
    runs in float64 (the reference's int32)."""
    jcfg, tcfg = _cfgs(adc_bits, saturate, **geometry)
    xn, wn = _operands((m, k), (k, n), seed=m * 7 + k)
    jprog = js.build_matmul_program(m, k, n, jcfg)
    tprog = ts.build_matmul_program(m, k, n, tcfg)
    x, w = torch.tensor(xn), torch.tensor(wn)
    got = ts.execute(tprog, x, w)
    assert got.shape == (m, n) and got.dtype == torch.float32 and got.is_contiguous()
    want = np.asarray(js.execute(jprog, jnp.asarray(xn), jnp.asarray(wn)))
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = ts.execute_reference(tprog, x, w)
    np.testing.assert_array_equal(
        oracle.numpy(), np.asarray(js.execute_reference(jprog, jnp.asarray(xn), jnp.asarray(wn))))
    assert torch.equal(oracle, got)
    fast = ts.execute(tprog, x, w, compiled=True)
    assert torch.equal(fast, got)
    assert np.linalg.norm(fast.numpy() - want) <= 1e-6 * np.linalg.norm(want)
    assert torch.equal(tp.matmul_via_array(x, w, tcfg), got)


def test_matmul_via_array_computes_the_matmul():
    xn, wn = _operands((3, 20), (20, 5), seed=1)
    x, w = torch.tensor(xn), torch.tensor(wn)
    y = tp.matmul_via_array(x, w, tp.PsramConfig(**SMALL))
    assert float(torch.linalg.norm(y - x @ w) / torch.linalg.norm(x @ w)) < 0.02
    assert tp.matmul_via_array(x[:0], w, tp.PsramConfig(**SMALL)).shape == (0, 5)
    with pytest.raises(ValueError):
        tp.matmul_via_array(x, w[:4], tp.PsramConfig(**SMALL))


@pytest.mark.parametrize("cap", [1, 4200, 8000, 40_000],
                         ids=["tile", "n_blocks", "one_k_tile", "k_chunks"])
def test_executor_chunking_changes_no_bit(cap, monkeypatch):
    """Chunks of K-tiles (and blocks of N-tiles where one K-tile passes the
    cap) fold in the same order: the same bits at any working-set cap."""
    cfg = tp.PsramConfig(**SMALL)
    xn, wn = _operands((13, 150), (150, 37), seed=5)
    prog = ts.build_matmul_program(13, 150, 37, cfg)
    x, w = torch.tensor(xn), torch.tensor(wn)
    whole = ts.execute(prog, x, w)
    monkeypatch.setattr(ts, "_CHUNK_BYTES", cap)
    cells = 4 * 4
    kc, nb = ts._chunking(16, 8, cells, 10, 5)
    assert (kc, nb) == {1: (1, 1), 4200: (1, 3), 8000: (1, 5), 40_000: (6, 5)}[cap]
    assert torch.equal(ts.execute(prog, x, w), whole)
    assert torch.equal(ts.execute_reference(prog, x, w), whole)


def test_fold_is_the_schedule_order():
    """The K-tiles fold as ``out = vals[0]; out = out + vals[i]``: at 64
    K-tiles a reordered sum (``vals.sum(0)``) changes bits, the port's fold
    does not, and it equals the reference's."""
    m, k, n = 8, 16 * 64, 16
    jcfg, tcfg = _cfgs(**SMALL)
    xn, wn = _operands((m, k), (k, n), seed=0)
    x, w = torch.tensor(xn), torch.tensor(wn)
    got = ts.execute(ts.build_matmul_program(m, k, n, tcfg), x, w)
    g = ts._tile_geometry(m, k, n, tcfg)
    vals = ts._tile_values(x, w, rows=16, cols=8, wav=4, mt=g["mt"], kt=g["kt"], nt=g["nt"],
                           adc=tcfg.adc, ctype=torch.float32)
    in_order = vals[0]
    for i in range(1, g["kt"]):
        in_order = in_order + vals[i]
    assert torch.equal(in_order.reshape(g["mt"] * 4, -1)[:m, :n], got)
    assert not torch.equal(vals.sum(0).reshape(g["mt"] * 4, -1)[:m, :n], got)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(js.execute(js.build_matmul_program(m, k, n, jcfg),
                                           jnp.asarray(xn), jnp.asarray(wn))))


@pytest.mark.parametrize("caller", ["high", "medium"])
def test_executor_pins_ieee_f32(caller, monkeypatch):
    """The batched contraction runs with TF32 off whatever the caller set,
    and the caller's setting comes back afterwards."""
    from repro_torch._device import _precision_switches

    def state():
        b = torch.backends
        if hasattr(b.cuda.matmul, "fp32_precision"):
            return b.cuda.matmul.fp32_precision == "ieee"
        return not b.cuda.matmul.allow_tf32

    seen = []
    real = torch.bmm

    def spy(*a, **kw):
        seen.append(state())
        return real(*a, **kw)

    saved = (torch.get_float32_matmul_precision(),
             [s.fp32_precision for s in _precision_switches()])
    try:
        torch.set_float32_matmul_precision(caller)
        before = torch.get_float32_matmul_precision()
        monkeypatch.setattr(torch, "bmm", spy)
        cfg = tp.PsramConfig(**SMALL)
        xn, wn = _operands((6, 40), (40, 9), seed=2)
        ts.execute(ts.build_matmul_program(6, 40, 9, cfg), torch.tensor(xn), torch.tensor(wn))
        assert seen and all(seen)
        assert torch.get_float32_matmul_precision() == before
    finally:
        torch.set_float32_matmul_precision(saved[0])
        for s, value in zip(_precision_switches(), saved[1]):
            s.fp32_precision = value


# -------------------------------------------------------------- primitives

def test_primitives_bit_equal_to_the_reference():
    """CP1–CP3 exact and through the array numerics, the fused row update,
    and CP 1 driven on a simulated crossbar tile (Fig. 3 layout, wavelength
    interleave), at ADC 16 and 6 bits."""
    rng = np.random.default_rng(11)
    b, c, a = (rng.standard_normal(20).astype(np.float32) for _ in range(3))
    xv = np.float32(rng.standard_normal())
    jb, jc, ja = jnp.asarray(b), jnp.asarray(c), jnp.asarray(a)
    tb, tc, ta = torch.tensor(b), torch.tensor(c), torch.tensor(a)
    eq = np.testing.assert_array_equal
    eq(tprim.cp1_exact(tb, tc).numpy(), np.asarray(jprim.cp1_exact(jb, jc)))
    eq(tprim.cp2_exact(float(xv), tb).numpy(), np.asarray(jprim.cp2_exact(xv, jb)))
    eq(tprim.cp3_exact(ta, tb).numpy(), np.asarray(jprim.cp3_exact(ja, jb)))
    eq(tprim.cp3_psram(ta, tb).numpy(), np.asarray(jprim.cp3_psram(ja, jb)))
    for bits in (16, 6):
        jadc, tadc = JADCConfig(bits), ADCConfig(bits)
        eq(tprim.cp1_psram(tb, tc, tadc).numpy(), np.asarray(jprim.cp1_psram(jb, jc, jadc)))
        eq(tprim.cp2_psram(torch.tensor(xv), tb, tadc).numpy(),
           np.asarray(jprim.cp2_psram(jnp.asarray(xv), jb, jadc)))
        eq(tprim.row_update_psram(ta, float(xv), tb, tc, tadc).numpy(),
           np.asarray(jprim.row_update_psram(ja, xv, jb, jc, jadc)))
    eq(tprim.row_update_exact(ta, float(xv), tb, tc).numpy(),
       np.asarray(jprim.row_update_exact(ja, xv, jb, jc)))
    jcfg, tcfg = _cfgs(rows=32, word_cols=4, wavelengths=6)
    on_array = tprim.cp1_on_array(tb, tc, tcfg)
    eq(on_array.numpy(), np.asarray(jprim.cp1_on_array(jb, jc, jcfg)))
    assert float(torch.linalg.norm(on_array - tb * tc) / torch.linalg.norm(tb * tc)) < 0.03
    with pytest.raises(ValueError, match="exceeds array rows"):
        tprim.cp1_on_array(torch.ones(40), torch.ones(40), tcfg)
