"""The dense MTTKRP pair of the port held against the JAX reference on the CPU.

Kernel level: the port's plain versions (what the wrappers use for CPU
tensors; what the CUDA kernels are held against on the card) and its ``"ref"``
oracles against the reference's Pallas kernels run in interpret mode, on
inputs made from a numpy seed. The psram variant is fed the reference's own
int8 codes and scales through ``repro_torch.convert`` (jitted JAX scales sit
one ulp off torch's on a few rows), so only the kernel arithmetic is compared.

Tolerances: the exact kernel is an f32 contraction summed in another order,
so rtol 1e-5 (atol 1e-5 of the largest magnitude, for entries that cancel);
the psram kernel digitises each ``bi``-row output tile over its own
``max|acc|``, so one ADC code of that tile's full scale plus rtol 1e-5.

Op and slice level: ``mttkrp_op`` / ``mttkrp_psram_op`` for every lowering,
and ``backends.get("hopper")`` on dense data (all modes) against the
reference ``"pallas"`` backend, fused and ``compiled=False``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import backends as jbackends
from repro.kernels import mttkrp as jk
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import api, backends, convert
from repro_torch.core.mttkrp import mttkrp_dense
from repro_torch.kernels import mttkrp as tk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _dense_case(i, j, k, r, seed=0):
    return _np((i, j * k), seed), _np((j, r), seed + 1), _np((k, r), seed + 2)


def _tile_codes(want, bi, adc_bits=16):
    """One ADC code of each ``bi``-row tile's full scale, per element."""
    i, r = want.shape
    bi = min(bi, i)
    fs = np.maximum(np.abs(want.reshape(i // bi, bi * r)).max(axis=1), 1e-30)
    return np.repeat(2.0 * fs / 2 ** adc_bits, bi)[:, None]


def _assert_exact_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def _assert_within_codes(got, want, bi, codes=1.0, rtol=1e-5):
    bound = codes * _tile_codes(want, bi) + rtol * np.abs(want)
    excess = np.abs(got - want) - bound
    assert (excess <= 0).all(), float(excess.max())


# ------------------------------------------------------------ kernel level

SHAPES = [
    (64, 4, 128, 8, 128, 128),     # one row tile, one k tile per j
    (256, 3, 256, 16, 128, 128),   # two row tiles, two k tiles per j
    (32, 5, 8, 5, 128, 128),       # bi = I, bk = K < 128, rank under 8
    (96, 2, 64, 12, 32, 32),       # smaller tiles than the defaults
]


@pytest.mark.parametrize("i,j,k,r,bi,bk", SHAPES)
def test_exact_plain_vs_interpreted_pallas_kernel(i, j, k, r, bi, bk):
    x0, b, c = _dense_case(i, j, k, r)
    want = np.asarray(jk.mttkrp_fused(jnp.asarray(x0), jnp.asarray(b), jnp.asarray(c),
                                      bi=bi, bk=bk, interpret=True))
    want_ref = np.asarray(jref.mttkrp_ref(jnp.asarray(x0), jnp.asarray(b), jnp.asarray(c)))
    tx0, tb, tc = (convert.dense(a, device="cpu") for a in (x0, b, c))
    plain = tk.mttkrp_fused_torch(tx0, tb, tc, bi=bi, bk=bk)
    before = tk.mttkrp_fused.launches
    assert torch.equal(tk.mttkrp_fused(tx0, tb, tc, bi=bi, bk=bk), plain)  # CPU → plain
    assert tk.mttkrp_fused.launches == before
    oracle = tref.mttkrp_ref(tx0, tb, tc)
    for got in (plain.numpy(), oracle.numpy()):
        for w in (want, want_ref):
            _assert_exact_close(got, w)


@pytest.mark.parametrize("i,j,k,r,bi,bk", SHAPES)
@pytest.mark.parametrize("adc_bits", [16, 8])
def test_psram_plain_vs_interpreted_pallas_kernel_and_xla_twin(i, j, k, r, bi, bk, adc_bits):
    x0, b, c = _dense_case(i, j, k, r, seed=3)
    jops_ = jk.quantize_mttkrp_operands(jnp.asarray(x0), jnp.asarray(b), jnp.asarray(c))
    kern = np.asarray(jk.mttkrp_psram_fused(*jops_, bi=bi, bk=bk, adc_bits=adc_bits,
                                            interpret=True))
    xla = np.asarray(jk.mttkrp_psram_xla(*jops_, bi=bi, adc_bits=adc_bits))
    oracle = np.asarray(jref.mttkrp_psram_ref(*jops_, bi=bi, adc_bits=adc_bits))
    tops_ = convert.mttkrp_quants(*[np.asarray(a) for a in jops_], device="cpu")
    assert [t.dtype for t in tops_] == [torch.int8, torch.float32] * 3
    plain = tk.mttkrp_psram_torch(*tops_, bi=bi, adc_bits=adc_bits)
    assert torch.equal(tk.mttkrp_psram_fused(*tops_, bi=bi, bk=bk, adc_bits=adc_bits), plain)
    got_ref = tref.mttkrp_psram_ref(*tops_, bi=bi, adc_bits=adc_bits)
    for got in (plain.numpy(), got_ref.numpy()):
        for want in (kern, xla, oracle):
            bound = _tile_codes(want, bi, adc_bits) + 1e-5 * np.abs(want)
            assert (np.abs(got - want) <= bound).all()
    # and inside the documented envelope of the exact product
    exact = x0 @ (b[:, None, :] * c[None]).reshape(j * k, r)
    assert np.linalg.norm(plain.numpy() - exact) / np.linalg.norm(exact) < 0.05


def test_quantized_operands_match_the_reference():
    """The port's own operand quantization: int8 codes equal to the
    reference's, scales within one f32 ulp of the jitted reference's."""
    x0, b, c = _dense_case(64, 4, 16, 8, seed=5)
    want = jk.quantize_mttkrp_operands(jnp.asarray(x0), jnp.asarray(b), jnp.asarray(c))
    got = tk.quantize_mttkrp_operands(*(convert.dense(a, device="cpu") for a in (x0, b, c)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if g.dtype == torch.int8:
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-7, atol=0)


def test_wrappers_keep_the_reference_preconditions():
    x0, b, c = (convert.dense(a, device="cpu") for a in _dense_case(96, 2, 64, 4))
    with pytest.raises(ValueError, match="I % bi"):
        tk.mttkrp_fused(x0, b, c, bi=64)                  # 96 % 64
    with pytest.raises(ValueError, match="K % bk"):
        tk.mttkrp_fused(x0, b, c, bk=48)                  # 64 % 48
    with pytest.raises(ValueError, match="unfolding"):
        tk.mttkrp_fused(x0[:, :-1], b, c)
    with pytest.raises(TypeError):
        tk.mttkrp_fused(x0.double(), b, c)
    q = tk.quantize_mttkrp_operands(x0, b, c)
    with pytest.raises(ValueError, match="I % bi"):
        tk.mttkrp_psram_fused(*q, bi=64)
    with pytest.raises(ValueError, match="I % bi"):
        tk.mttkrp_psram_torch(*q, bi=64)
    with pytest.raises(TypeError):
        tk.mttkrp_psram_fused(q[0].float(), *q[1:])
    with pytest.raises(ValueError, match="scales"):
        tk.mttkrp_psram_fused(q[0], q[1][:-1], *q[2:])
    # the kernel's split of the contraction is index arithmetic: every split
    # holds at least one stage and together they hold all of them
    # (and a plan for larger tiles, fewer CTAs a SM, fills the card in one wave)
    for i, jk_, r in ((1024, 884736, 32), (5, 32, 3), (128, 33, 40), (4096, 100000, 64),
                      (1152, 786432, 32)):
        n_chunks = -(-jk_ // tk.TK)
        for ti, per_sm in ((tk.TI, 8), (256, 3)):
            splits, per = tk.split_plan(132, i, jk_, r, ti, per_sm)
            assert 1 <= splits <= 65535 and (splits - 1) * per < n_chunks <= splits * per
            ctas = -(-i // ti) * -(-r // tk.TR)
            assert splits * ctas <= max(per_sm * 132, ctas)


# ---------------------------------------------------------------- op level


@pytest.mark.parametrize("lowering", ["auto", "torch", "ref"])
def test_ops_vs_reference_ops(lowering):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((64, 4, 32)).astype(np.float32)
    b, c = _np((4, 6), 10), _np((32, 6), 11)
    tx, tb, tc = (convert.dense(a, device="cpu") for a in (x, b, c))
    jx, jb, jc = (jnp.asarray(a) for a in (x, b, c))
    want = np.asarray(jops.mttkrp_op(jx, jb, jc, backend="ref"))
    _assert_exact_close(tops.mttkrp_op(tx, tb, tc, lowering=lowering).numpy(), want)
    # the port quantizes for itself: scales within one ulp → within two codes
    want_q = np.asarray(jops.mttkrp_psram_op(jx, jb, jc, backend="xla"))
    got_q = tops.mttkrp_psram_op(tx, tb, tc, lowering=lowering).numpy()
    _assert_within_codes(got_q, want_q, 128, codes=2.0)
    with pytest.raises(ValueError, match="3-mode"):
        tops.mttkrp_op(tx[0], tb, tc, lowering=lowering)


def test_op_errors_and_store_cache():
    tx = convert.dense(np.ones((8, 2, 4), np.float32), device="cpu")
    tb = convert.dense(_np((2, 3), 1), device="cpu")
    tc = convert.dense(_np((4, 3), 2), device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        tops.mttkrp_op(tx, tb, tc, lowering="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        tops.mttkrp_psram_op(tx, tb, tc, lowering="cuda")
    first = tops._stored((tb, tc), "mttkrp_bc", tops._store_mttkrp_factors)
    assert tops._stored((tb, tc), "mttkrp_bc", tops._store_mttkrp_factors) is first
    assert tops._stored((tb.clone(), tc), "mttkrp_bc", tops._store_mttkrp_factors) is not first


# ------------------------------------------------------------- slice level

DENSE_SHAPE = (64, 4, 128)
RANK = 8


@pytest.fixture(scope="module")
def dense_case():
    x = np.random.default_rng(21).standard_normal(DENSE_SHAPE).astype(np.float32)
    fs = [_np((s, RANK), 22 + d) for d, s in enumerate(DENSE_SHAPE)]
    return x, fs


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_hopper_dense_vs_reference_pallas(mode, dense_case):
    x, fs = dense_case
    want = np.asarray(jbackends.get("pallas", lowering="xla").mttkrp(
        jnp.asarray(x), tuple(jnp.asarray(f) for f in fs), mode))
    tx = convert.dense(x, device="cpu")
    tfs = tuple(convert.factors(fs, device="cpu"))
    got = backends.get("hopper").mttkrp(tx, tfs, mode)
    assert tuple(got.shape) == (DENSE_SHAPE[mode], RANK)
    # the dense ops run at their defaults (bi = 128) in both packages
    _assert_within_codes(got.numpy(), want, 128, codes=2.0)
    np.testing.assert_array_equal(api.mttkrp(tx, tfs, mode, backend="hopper").numpy(),
                                  got.numpy())
    exact = mttkrp_dense(tx, list(tfs), mode).numpy()
    assert np.linalg.norm(got.numpy() - exact) / np.linalg.norm(exact) < 0.05


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_hopper_legacy_dense_vs_reference_pallas(mode, dense_case):
    x, fs = dense_case
    want = np.asarray(jbackends.get("pallas", compiled=False, lowering="interpret").mttkrp(
        jnp.asarray(x), tuple(jnp.asarray(f) for f in fs), mode))
    tx = convert.dense(x, device="cpu")
    tfs = tuple(convert.factors(fs, device="cpu"))
    be = backends.get("hopper", compiled=False)
    assert not be.capabilities().compiled
    assert be.capabilities().description.endswith("[legacy per-op]")
    got = be.mttkrp(tx, tfs, mode)
    _assert_exact_close(got.numpy(), want)
    _assert_exact_close(got.numpy(), mttkrp_dense(tx, list(tfs), mode).numpy())
