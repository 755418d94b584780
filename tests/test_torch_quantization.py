"""repro_torch.core.quantization held against the JAX reference on the CPU.

Inputs are made from a seed with numpy and handed to both packages. The
reference runs as its callers run it: ``quantize_symmetric`` jitted (the
kernel ops jit it) and eagerly. Measured on this pair of frameworks (numpy
seeds 0/1, 15.8M elements): int8 codes identical everywhere; the *scales* of
the jitted reference differ from torch's by one f32 ulp on ~5% of rows (XLA
rewrites ``amax / 127`` into a multiply by the reciprocal; eager XLA and
torch divide). The kernel-level tests therefore feed the reference's own
codes and scales to the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import quantization as jq
from repro_torch.core import quantization as tq

ULP = float(np.finfo(np.float32).eps)


def _t(a):
    return torch.tensor(np.asarray(a))


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape,axis", [
    ((64, 128), -1), ((64, 128), 0), ((1000,), None), ((4, 8, 16), (1, 2)),
])
def test_quantize_symmetric_equals_eager_reference(shape, axis):
    """Eager XLA and torch both do a true division: codes AND scales equal."""
    x = _rand(shape)
    qj, sj = jq.quantize_symmetric(jnp.asarray(x), axis=axis)
    qt, st = tq.quantize_symmetric(_t(x), axis=axis)
    assert qt.dtype == torch.int8 and tuple(st.shape) == tuple(sj.shape)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("shape,axis", [
    ((1024, 512), -1), ((1024, 512), 0), ((512, 512), None),
])
def test_quantize_symmetric_vs_jitted_reference(shape, axis):
    """Against the *jitted* reference: codes at most 1 apart on at most 1e-4
    of the elements (measured: 0 of 15.8M), scales within one f32 ulp
    (measured: ~5% of per-row scales one ulp apart, per-tensor scales equal)."""
    x = _rand(shape, seed=1)
    qj, sj = jax.jit(jq.quantize_symmetric, static_argnames="axis")(
        jnp.asarray(x), axis=axis)
    qt, st = tq.quantize_symmetric(_t(x), axis=axis)
    d = np.abs(qt.numpy().astype(np.int32) - np.asarray(qj).astype(np.int32))
    assert d.max() <= 1
    assert (d > 0).mean() <= 1e-4
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1.5 * ULP, atol=0)


def test_dequantize_and_bitplanes_equal_reference():
    x = _rand((32, 48), seed=2)
    qj, sj = jq.quantize_symmetric(jnp.asarray(x), axis=-1)
    q, s = _t(qj), _t(sj)
    np.testing.assert_array_equal(tq.dequantize(q, s).numpy(),
                                  np.asarray(jq.dequantize(qj, sj)))
    sign_j, planes_j = jq.to_bitplanes(qj)
    sign_t, planes_t = tq.to_bitplanes(q)
    assert sign_t.dtype == torch.int8 and planes_t.dtype == torch.uint8
    np.testing.assert_array_equal(sign_t.numpy(), np.asarray(sign_j))
    np.testing.assert_array_equal(planes_t.numpy(), np.asarray(planes_j))
    back = tq.from_bitplanes(sign_t, planes_t)
    assert back.dtype == torch.int8
    np.testing.assert_array_equal(back.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jq.from_bitplanes(sign_j, planes_j)))


@pytest.mark.parametrize("levels,saturate", [(2 ** 16, True), (2 ** 8, True),
                                             (2 ** 4, False)])
def test_adc_transfer_equals_reference(levels, saturate):
    """Scalar full scale (LSB formed in double, rounded once) and tensor full
    scale (LSB formed in f32), incl. values past the rails and exact ties."""
    rng = np.random.default_rng(3)
    acc = (rng.standard_normal((64, 33)) * 3e4).astype(np.float32)
    full = 127.0 * 127.0 * 8
    lsb = np.float32(2.0 * full / levels)
    acc[0, :8] = (np.arange(8) + 0.5) * lsb          # ties: half-to-even
    want = jq.adc_transfer(jnp.asarray(acc), levels, full, saturate)
    got = tq.adc_transfer(_t(acc), levels, full, saturate)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fs = np.abs(acc).max(axis=1, keepdims=True)
    want = jq.adc_transfer(jnp.asarray(acc), levels, jnp.asarray(fs), saturate)
    got = tq.adc_transfer(_t(acc), levels, _t(fs), saturate)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # integer accumulators convert to f32 first, as the reference does
    acc_i = rng.integers(-2 ** 20, 2 ** 20, size=(16, 16)).astype(np.int32)
    np.testing.assert_array_equal(
        tq.adc_transfer(_t(acc_i), levels, full, saturate).numpy(),
        np.asarray(jq.adc_transfer(jnp.asarray(acc_i), levels, full, saturate)))


def test_adc_requantize_equals_reference():
    acc = (_rand((16, 16), seed=4) * 1e3).astype(np.float32)
    for bits in (6, 16):
        want = jq.adc_requantize(jnp.asarray(acc), jq.ADCConfig(bits=bits), 4096.0)
        got = tq.adc_requantize(_t(acc), tq.ADCConfig(bits=bits), 4096.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tq.ADCConfig(bits=12).levels == jq.ADCConfig(bits=12).levels == 4096
    assert tq.QMAX == jq.QMAX and tq.WORD_BITS == jq.WORD_BITS


def test_fake_quant_value_and_straight_through_gradient():
    x = _rand((8, 16), seed=5)
    want = jq.fake_quant(jnp.asarray(x), axis=-1)
    xt = _t(x).requires_grad_(True)
    got = tq.fake_quant(xt, axis=-1)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    w = _rand((8, 16), seed=6)
    (got * _t(w)).sum().backward()
    grad_j = jax.grad(lambda v: jnp.sum(jq.fake_quant(v, axis=-1) * w))(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(grad_j))
    np.testing.assert_array_equal(xt.grad.numpy(), w)      # identity gradient


@pytest.mark.parametrize("m,k,n", [(8, 16, 8), (5, 33, 9), (4, 2048, 8)])
def test_psram_quantized_matmul_vs_reference(m, k, n):
    """The reference is one jit, so its per-column scales may sit one ulp
    from torch's (see module docstring): equal codes, hence equal ADC
    output, times scales within 2 ulp — rtol 4e-7. Inside the documented
    envelope (rel < 0.05) of the float product."""
    x, w = _rand((m, k), seed=7), _rand((k, n), seed=8)
    want = np.asarray(jq.psram_quantized_matmul(jnp.asarray(x), jnp.asarray(w)))
    got = tq.psram_quantized_matmul(_t(x), _t(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=4e-7, atol=0)
    rel = np.linalg.norm(got - x @ w) / np.linalg.norm(x @ w)
    assert rel < 0.05


def test_exact_int_matmul_is_exact_past_2_24():
    rng = np.random.default_rng(9)
    qa = rng.integers(-127, 128, size=(6, 4096)).astype(np.int8)
    qb = rng.integers(-127, 128, size=(4096, 5)).astype(np.int8)
    qa[0], qb[:, 0] = 127, 127                      # 127^2 * 4096 > 2^24
    want = qa.astype(np.int64) @ qb.astype(np.int64)
    got = tq.exact_int_matmul(_t(qa), _t(qb))
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  want.astype(np.int32).astype(np.float32))
