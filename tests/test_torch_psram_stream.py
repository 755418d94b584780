"""The ``psram-stream`` slice of the port held against the JAX reference on
the CPU: the quantized chain, the eager and compiled streaming executors,
the plain versions of the two chain routes' quantized variants, the
``psram-oracle`` / ``psram-stream`` backends, ``cp_als_psram`` and the
``api`` defaults.

The quantized chain (``cp_chain_psram``: 8-bit operands and the ADC on every
product) divides by true divisions, so the port is **bit-equal** to the
reference run op by op (``jax.disable_jit()``). Jitted, XLA rewrites
``amax / 127`` into a reciprocal multiply: a one-ulp scale moves a code now
and then, so against the jitted reference the bound is one ADC code of full
scale, ``2^(1 - adc_bits) · max|out|``, for the MTTKRP; a chain row alone
may move by one 8-bit operand code instead (``max|out| / 127``), which is
the coarser of the two at 16 bits. The compiled (blocked-segment) fold
reassociates the adds: within 1e-5 relative (plus that code) of the
reference's compiled executor, and 1e-6 of the port's flat oracle.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import mttkrp as jm
from repro.core.psram import PsramConfig as JPsramConfig
from repro.sparse import formats as jf
from repro.sparse import stream as jstream
from repro.sparse import synth as jsynth
from repro_torch import api, backends, convert
from repro_torch.core import cp_als as t_cp
from repro_torch.core import mttkrp as tm
from repro_torch.core.psram import PsramConfig
from repro_torch.core.quantization import ADCConfig, adc_requantize
from repro_torch.kernels import ordered_fold as of
from repro_torch.kernels import segment_sum as ss
from repro_torch.kernels.ops import blocked_chain_segment_sum_op
from repro_torch.sparse import formats as tf
from repro_torch.sparse import stream as tstream
from repro_torch.sparse import synth as tsynth

j_cp = importlib.import_module("repro.core.cp_als")   # the module, not the function


def _pair(seed_key, shape, nnz, alpha):
    key = jax.random.PRNGKey(seed_key)
    ref = jsynth.powerlaw_coo(key, shape, nnz=nnz, rank=4, alpha=alpha)
    seed = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
    port = tsynth.powerlaw_coo(seed, shape, nnz=nnz, rank=4, alpha=alpha, device="cpu")
    return ref, port


def _factors(shape, rank, seed):
    rng = np.random.default_rng(seed)
    fs = [rng.standard_normal((s, rank)).astype(np.float32) for s in shape]
    return tuple(jnp.asarray(f) for f in fs), tuple(torch.tensor(f) for f in fs)


def _one_code(out, adc_bits):
    """One ADC code of full scale: ``2^(1 - adc_bits) · max|out|``."""
    return 2.0 ** (1 - adc_bits) * float(np.abs(out).max())


def _one_operand_or_adc_code(out, adc_bits):
    """The coarser of one ADC code and one 8-bit operand code of full scale:
    ``max(2^(1 - adc_bits), 1 / 127) · max|out|``."""
    return max(2.0 ** (1 - adc_bits), 1.0 / 127) * float(np.abs(out).max())


# ------------------------------------------------------------ the chain

@pytest.mark.parametrize("rank", [5, 20, 32, 48])
@pytest.mark.parametrize("shape", [(30, 20, 10), (12, 9, 8, 7)], ids=["3modes", "4modes"])
def test_chain_bit_equal_to_the_reference_op_by_op(shape, rank):
    """``cp_chain_psram`` at ADC 4 / 8 / 16 bits, every mode: bit-equal to the
    reference under ``jax.disable_jit()``; against the jitted reference,
    within one ADC code or one 8-bit operand code of full scale, whichever
    is coarser (a one-ulp scale there moves a code now and then); leading
    batch dims change no bit."""
    rng = np.random.default_rng(rank + len(shape))
    nnz = 400
    idx = np.stack([rng.integers(0, s, nnz) for s in shape], 1).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    vals[::17] = 0.0                                    # zero values: codes 0
    jfs, tfs = _factors(shape, rank, rank)
    for bits in (4, 8, 16):
        for mode in range(len(shape)):
            args = (jnp.asarray(idx), jnp.asarray(vals), jfs, mode, bits)
            with jax.disable_jit():
                want = np.asarray(jm.cp_chain_psram(*args))
            jitted = np.asarray(jax.jit(jm.cp_chain_psram, static_argnums=(3, 4))(*args))
            got = tm.cp_chain_psram(torch.tensor(idx), torch.tensor(vals), tfs, mode, bits)
            np.testing.assert_array_equal(got.numpy(), want)
            assert np.abs(got.numpy() - jitted).max() <= _one_operand_or_adc_code(jitted, bits)
            blocked = tm.cp_chain_psram(torch.tensor(idx).view(8, 50, -1),
                                        torch.tensor(vals).view(8, 50), tfs, mode, bits)
            assert torch.equal(blocked.reshape(nnz, rank), got)


@pytest.mark.parametrize("bits", [4, 16])
def test_adc_clamp_fires_on_every_nonzero(bits, monkeypatch):
    """A full-scale product (the value's code +-127 times the chain's amax
    column's) is code ``2^(adc_bits - 1)``, one past the rail: the clamp
    fires on every nonzero row. A chain without it differs on each row whose
    value is not zero."""
    adc = ADCConfig(bits=bits)
    lsb, code_max, _ = of.adc_operands(bits)
    rail = adc_requantize(torch.tensor([16129, -16129], dtype=torch.int32), adc, 16129.0)
    assert torch.equal(rail, torch.tensor([code_max, -code_max]) * torch.tensor(lsb))
    assert code_max == adc.levels // 2 - 1 and 16129 / lsb == adc.levels // 2
    rng = np.random.default_rng(bits)
    idx = torch.tensor(np.stack([rng.integers(0, 9, 300) for _ in range(3)], 1))
    vals = torch.tensor(rng.standard_normal(300).astype(np.float32))
    vals[::10] = 0.0
    fs = tuple(torch.tensor(rng.standard_normal((9, 32)).astype(np.float32)) for _ in range(3))
    clamped = tm.cp_chain_psram(idx, vals, fs, 0, bits)
    unclamped_adc = ADCConfig(bits=bits, saturate=False)
    monkeypatch.setattr(tm, "adc_requantize", lambda acc, _, fs_: adc_requantize(
        acc, unclamped_adc, fs_))
    unclamped = tm.cp_chain_psram(idx, vals, fs, 0, bits)
    differs = (clamped != unclamped).any(dim=1)
    assert torch.equal(differs, vals != 0)


# ------------------------------------------------------- the eager stream

STREAMS = [  # (seed key, shape, nnz, alpha): skewed 3-mode, 4 modes
    (11, (40, 30, 20), 2500, 1.6), (12, (14, 10, 9, 8), 2000, 0.8),
]


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("stream", STREAMS, ids=["3modes", "4modes"])
def test_eager_stream_bit_equal_to_the_reference(stream, bits):
    """``mttkrp_sparse_psram`` (COO) and the eager ``stream_mttkrp(psram=True)``
    (CSF, with and without ``exec_blocks``): bit-equal to each other and to
    the reference's ``mttkrp_sparse_psram`` run op by op; within one ADC
    code of the jitted reference's ``stream_mttkrp(psram=True)``. Also
    ``mttkrp_sparse_psram_scheduled`` and ``stream_mttkrp_coo``."""
    seed_key, shape, nnz, alpha = stream
    ref, port = _pair(seed_key, shape, nnz, alpha)
    jfs, tfs = _factors(shape, 20, seed_key)
    for mode in range(len(shape)):
        got = tm.mttkrp_sparse_psram(port.indices, port.values, tfs, mode, shape[mode],
                                     adc_bits=bits)
        with jax.disable_jit():
            want = np.asarray(jm.mttkrp_sparse_psram(ref.indices, ref.values, jfs, mode,
                                                     shape[mode], adc_bits=bits))
        np.testing.assert_array_equal(got.numpy(), want)
        tc = tf.csf_for_mode(port, mode)
        for cfg, eb in ((None, None), (PsramConfig(rows=16), 3)):
            stream_got = tstream.stream_mttkrp(tc, tfs, cfg, psram=True, adc_bits=bits,
                                               exec_blocks=eb)
            assert torch.equal(stream_got, got)
        jitted = np.asarray(jstream.stream_mttkrp(jf.csf_for_mode(ref, mode), jfs, psram=True,
                                                  adc_bits=bits))
        assert np.abs(got.numpy() - jitted).max() <= _one_code(jitted, bits)
        if bits == 16:
            assert torch.equal(tm.mttkrp_sparse_psram_scheduled(
                port.indices, port.values, tfs, mode, shape[mode]), got)
        assert torch.equal(tstream.stream_mttkrp_coo(port.indices, port.values, tfs, mode,
                                                     shape[mode], psram=True, adc_bits=bits),
                           got)


# ---------------------------------------------------- the compiled stream

@pytest.mark.parametrize("psram", [False, True], ids=["exact", "psram"])
@pytest.mark.parametrize("stream", STREAMS, ids=["3modes", "4modes"])
def test_compiled_stream_against_the_reference_and_the_flat_oracle(stream, psram):
    """``stream_mttkrp(compiled=True)`` with either chain: within 1e-5
    relative (plus one ADC code with the quantized chain) of the reference's
    compiled executor run op by op (jitted, its chain moves an 8-bit operand
    code now and then, as in the chain test); within 1e-6 relative of the
    port's flat oracle
    (``blocked_fold_reference`` and its COO door ``mttkrp_sparse_blocked``);
    with the exact chain bit-equal to ``stream_mttkrp_blocked``, whose
    ``psram=True`` it is otherwise."""
    seed_key, shape, nnz, alpha = stream
    ref, port = _pair(seed_key, shape, nnz, alpha)
    jfs, tfs = _factors(shape, 20, seed_key + 1)
    cfg, jcfg = PsramConfig(rows=32), JPsramConfig(rows=32)
    for mode in range(len(shape)):
        tc = tf.csf_for_mode(port, mode)
        got = tstream.stream_mttkrp(tc, tfs, cfg, psram=psram, compiled=True)
        with jax.disable_jit():
            want = np.asarray(jstream.stream_mttkrp(jf.csf_for_mode(ref, mode), jfs, jcfg,
                                                    psram=psram, compiled=True))
        scale = float(np.abs(want).max())
        atol = 1e-5 * scale + (_one_code(want, 16) if psram else 0.0)
        assert np.abs(got.numpy() - want).max() <= atol
        flat = tstream.blocked_fold_reference(tc, tfs, cfg, psram=psram)
        coo_door = tm.mttkrp_sparse_blocked(port.indices, port.values, tfs, mode, shape[mode],
                                            config=cfg, psram=psram)
        assert torch.equal(flat, coo_door)
        np.testing.assert_allclose(got.numpy(), flat.numpy(), rtol=0, atol=1e-6 * scale)
        blocked = tstream.stream_mttkrp_blocked(tc, tfs, cfg, psram=psram)
        assert torch.equal(got, blocked)
        if not psram:
            assert torch.equal(got, tstream.stream_mttkrp_blocked(tc, tfs, cfg))
        else:                       # the same quantized chain, another fold
            eager = tstream.stream_mttkrp(tc, tfs, cfg, psram=True)
            assert np.abs((got - eager).numpy()).max() <= 1e-5 * scale


# ------------------------------------- the chain routes' plain versions

@pytest.mark.parametrize("bits", [4, 16])
@pytest.mark.parametrize("rank,stream", [(5, STREAMS[0]), (32, STREAMS[0]), (48, STREAMS[1])])
def test_chain_routes_plain_versions_equal_the_chain_and_the_folds(rank, stream, bits):
    """The quantized variants' plain versions: the ordered fold's chain route
    (``ordered_chain_fold_torch(psram=True)``) bit-equal to
    ``cp_chain_psram`` over the stream + ``ordered_fold_torch``; kernel 5's
    (``blocked_chain_segment_sum_torch(psram=True)`` and the op) bit-equal
    to ``cp_chain_psram`` over the padded stream + ``blocked_segment_sum_torch``
    (the padding adds zeros)."""
    seed_key, shape, nnz, alpha = stream
    _, port = _pair(seed_key, shape, nnz, alpha)
    _, tfs = _factors(shape, rank, rank)
    mode = 0
    csf = tf.csf_for_mode(port, mode)
    coords, seg_ptr, seg_rows, *_ = tstream._chain_stream(csf)
    start = torch.tensor(np.random.default_rng(rank).standard_normal(
        (shape[mode], rank)).astype(np.float32))
    got = of.ordered_chain_fold_torch(start.clone(), coords, csf.values, tfs, mode, seg_ptr,
                                      seg_rows, psram=True, adc_bits=bits)
    idx = csf.expanded_indices()
    chain = tm.cp_chain_psram(idx, csf.values, tfs, mode, bits)
    assert torch.equal(got, of.ordered_fold_torch(start.clone(), chain, idx[:, mode]))
    local, n_seg = tstream._segment_blocks(csf, 64)[:2]
    parts = ss.blocked_chain_segment_sum_torch(coords, csf.values, local, tfs, mode, n_seg,
                                               psram=True, adc_bits=bits)
    b, bn = local.shape
    pad = b * bn - csf.nnz
    padded = tm.cp_chain_psram(torch.nn.functional.pad(idx, (0, 0, 0, pad)).view(b, bn, -1),
                               torch.nn.functional.pad(csf.values, (0, pad)).view(b, bn), tfs,
                               mode, bits)
    assert torch.equal(parts, ss.blocked_segment_sum_torch(padded, local, n_seg))
    assert torch.equal(blocked_chain_segment_sum_op(coords, csf.values, local, tfs, mode, n_seg,
                                                    psram=True, adc_bits=bits), parts)
    ref_parts = blocked_chain_segment_sum_op(coords, csf.values, local, tfs, mode, n_seg,
                                             lowering="ref", psram=True, adc_bits=bits)
    np.testing.assert_allclose(ref_parts.numpy(), parts.numpy(), rtol=1e-6, atol=1e-6)


def test_quantized_chain_wrappers_refuse_cpu_tensors_and_bad_bits():
    """The kernels' wrappers take CUDA tensors only and an ADC of 1..24 bits;
    nothing launches."""
    _, port = _pair(11, (40, 30, 20), 300, 1.1)
    _, tfs = _factors((40, 30, 20), 8, 0)
    csf = tf.csf_for_mode(port, 1)
    coords, seg_ptr, seg_rows, *_ = tstream._chain_stream(csf)
    local, n_seg = tstream._segment_blocks(csf, 64)[:2]
    routes = (dict(of.ordered_fold.routes), dict(ss.blocked_segment_sum.routes))
    out = torch.zeros((30, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        of.ordered_chain_fold(out, coords, csf.values, tfs, 1, seg_ptr, seg_rows, psram=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ss.blocked_chain_segment_sum(coords, csf.values, local, tfs, 1, n_seg, psram=True)
    with pytest.raises(ValueError, match="1..24"):
        of.adc_operands(25)
    assert of.adc_operands(16) == (2.0 * 16129 / 65536, 32767.0, float(np.float32(65536 / 32258)))
    assert (dict(of.ordered_fold.routes), dict(ss.blocked_segment_sum.routes)) == routes
    assert set(of.ordered_fold.routes) == {"fold", "chain", "chain_psram"}
    assert set(ss.blocked_segment_sum.routes) == {"rows", "chain", "chain_psram"}


# ------------------------------------- backends, cp_als_psram, the api

@pytest.fixture(scope="module")
def sparse_data():
    coo = tsynth.powerlaw_coo(7, (40, 30, 20), nnz=1500, rank=3, alpha=1.1, device="cpu")
    rng = np.random.default_rng(3)
    fs = tuple(torch.tensor(rng.standard_normal((s, 5)).astype(np.float32)) for s in coo.shape)
    return coo, fs


@pytest.mark.parametrize("name,kw", [("psram-stream", {}), ("psram-stream", {"compiled": True}),
                                     ("psram-oracle", {})],
                         ids=["stream", "stream-compiled", "oracle"])
def test_backends_within_rel_tol_of_exact(name, kw, sparse_data):
    """On sparse data (container, CSF, COO triple) and on dense data
    (COO-ified): within the backend's ``rel_tol`` of ``exact``; the eager
    stream bit-equal to the oracle's flat chain on the sorted stream."""
    coo, fs = sparse_data
    be = backends.get(name, **kw)
    caps = be.capabilities()
    assert caps.lossy and caps.rel_tol == 0.05 and caps.cost_model
    assert caps.matmul is (name == "psram-oracle")
    assert caps.bit_exact is not kw.get("compiled", False)
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((7, 6, 5)).astype(np.float32))
    xfs = tuple(torch.tensor(rng.standard_normal((s, 4)).astype(np.float32)) for s in x.shape)
    for mode in range(3):
        csf = tf.csf_for_mode(coo, mode)
        want = backends.get("exact").mttkrp(csf, fs, mode)
        for data in (coo, csf, (coo.indices, coo.values, coo.shape)):
            got = be.mttkrp(data, fs, mode)
            assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) < caps.rel_tol
        if name == "psram-stream" and not kw:
            assert torch.equal(be.mttkrp(csf, fs, mode),
                               backends.get("psram-oracle").mttkrp(coo, fs, mode))
        dense_want = backends.get("exact").mttkrp(x, xfs, mode)
        dense_got = be.mttkrp(x, xfs, mode)
        assert float(torch.linalg.norm(dense_got - dense_want)
                     / torch.linalg.norm(dense_want)) < caps.rel_tol
    # each prices its own kind of workload and refuses the other
    other = (backends.describe(coo, rank=5) if name == "psram-oracle"
             else backends.describe(x, rank=4))
    with pytest.raises(backends.CapabilityError):
        be.cost(other)
    if name == "psram-oracle":           # the per-cycle array matmul: the scheduled one's bits
        assert torch.equal(be.matmul(x[0], x[0].T),
                           backends.get("psram-scheduled").matmul(x[0], x[0].T))


@pytest.mark.parametrize("container", [False, True], ids=["triple", "container"])
def test_cp_als_psram_reaches_the_reference_fit(container):
    """``cp_als_psram`` from the reference's initial factors (carried across
    as arrays): on a COO triple (``psram-oracle``) and on a container
    (``psram-stream``), the fit within 1e-4 of the reference's after the same
    sweeps, at a 12-bit ADC."""
    key = jax.random.PRNGKey(7)
    j_coo = jsynth.powerlaw_coo(key, (40, 30, 20), nnz=1500, rank=3, alpha=1.1)
    rank, n_iter, bits = 4, 4, 12
    als_key = jax.random.PRNGKey(11)
    init = [np.asarray(f) for f in j_cp.init_factors(als_key, j_coo.shape, rank)]
    t_coo = convert.coo(np.asarray(j_coo.indices), np.asarray(j_coo.values), j_coo.shape,
                        mode_order=j_coo.mode_order, device="cpu")
    if container:
        ref = j_cp.cp_als_psram(j_coo, rank, n_iter=n_iter, key=als_key, adc_bits=bits)
        got = t_cp.cp_als_psram(t_coo, rank, n_iter=n_iter, adc_bits=bits, init=init)
    else:
        triple = (j_coo.indices, j_coo.values, j_coo.shape)
        ref = j_cp.cp_als_psram(triple, rank, n_iter=n_iter, key=als_key, adc_bits=bits)
        got = t_cp.cp_als_psram((t_coo.indices, t_coo.values, t_coo.shape), rank,
                                n_iter=n_iter, adc_bits=bits, init=init)
    assert got.iters == ref.iters
    assert abs(got.fit - ref.fit) < 1e-4


def test_api_defaults_to_psram_stream(sparse_data):
    """``api.mttkrp`` and ``api.execute`` with no ``backend=`` run
    ``"psram-stream"``; ``api.matmul`` runs ``"psram-scheduled"``, as the
    reference's does, and ``"hopper"`` when named."""
    coo, fs = sparse_data
    for mode in range(3):
        want = backends.get("psram-stream").mttkrp(coo, fs, mode)
        assert torch.equal(api.mttkrp(coo, fs, mode), want)
        assert torch.equal(api.execute(api.MTTKRPProblem(coo, fs, mode)), want)
    x, w = fs[0], fs[1].T
    assert torch.equal(api.matmul(x, w), backends.get("psram-scheduled").matmul(x, w))
    assert torch.equal(api.matmul(x, w, backend="hopper"), backends.get("hopper").matmul(x, w))
