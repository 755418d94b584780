"""Kernel 2's K split across cards, the decode rows' pieces, held on the CPU.

A row-parallel pSRAM projection (K on the ``"model"`` axis) sums each
card's K slice in int32, all-reduces the sums and runs the ADC epilogue on
the whole K. Decode rows take ``psram_matmul_int32_rows``, one launch that
quantizes its own rows; the epilogue launch writes the projection's dtype.
Here their plain versions (what the wrappers use for CPU tensors, and what
the CUDA kernels are held bit-equal to on the card) are held to

* the composition they replace and an independent numpy form of the
  kernel's arithmetic (an f32 true division, one rounding to bf16 for bf16
  rows, round-half-even, the clamp), bit for bit;
* the reference, ``quantize_symmetric`` over the whole K followed by
  ``psram_matmul_ref``, run op by op (``jax.disable_jit()``: jitted XLA
  divides by 127 through a reciprocal), bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.quantization import quantize_symmetric as jq_quantize
from repro.kernels.ref import psram_matmul_ref
from repro_torch.core.quantization import QMAX, symmetric_scale
from repro_torch.kernels import psram_matmul as pm

K, N = 256, 24


def _bf16_rne(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bf16, ties to even (finite
    inputs), as float32."""
    u = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _numpy_codes(x: torch.Tensor, sx: torch.Tensor) -> np.ndarray:
    """The kernel's arithmetic, written in numpy: the quotient in f32, once
    rounded to bf16 for bf16 rows, then rint and the clamp."""
    q = x.float().numpy() / sx.float().numpy()
    if x.dtype == torch.bfloat16:
        q = _bf16_rne(q)
    return np.clip(np.rint(q), -QMAX, QMAX).astype(np.int64)


def _rows(m: int, dtype: torch.dtype, seed: int):
    """``m`` rows of K values and their scales in ``dtype``: normal draws
    scaled by a maximum up to twice their own (a slice of a wider row); with
    three rows or more, row 0 all zero (the 1e-12 clamp of
    ``symmetric_scale``), row 1 exact .5 quotients and row 2 quotients at
    and past ±127 (both sx = 1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, K)).astype(np.float32)
    amax = np.abs(x).max(axis=1, keepdims=True) * rng.uniform(1.0, 2.0, (m, 1))
    halves = (rng.integers(-127, 127, K) + 0.5).astype(np.float32)
    rails = rng.choice(np.array([127.5, 128.0, 300.0, 126.5, 127.0], np.float32), K)
    rails *= rng.choice(np.array([-1.0, 1.0], np.float32), K)
    if m >= 3:
        x[:3] = np.stack([np.zeros(K, np.float32), halves, rails])
        amax[:3] = [[0.0], [1.0], [1.0]]
    xt = torch.tensor(x).to(dtype)
    sx = symmetric_scale(torch.tensor(amax.astype(np.float32)).to(dtype))
    if m >= 3:
        sx[1:3] = 1.0
    return xt, sx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 8, 16])
def test_rows_plain_equals_composition(m, dtype):
    x, sx = _rows(m, dtype, seed=m)
    qw = torch.tensor(np.random.default_rng(100 + m).integers(-127, 128, (K, N)),
                      dtype=torch.int8)
    got = pm.psram_matmul_int32_rows(x, sx, qw)
    composition = pm.psram_matmul_int32(
        torch.round(x / sx).clamp(-QMAX, QMAX).to(torch.int8), qw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, N)
    assert torch.equal(got, composition)
    codes = _numpy_codes(x, sx)
    assert np.array_equal(got.numpy(), codes @ qw.numpy().astype(np.int64))
    if m >= 3:   # the special rows do what they stand for
        assert not codes[0].any()
        assert set(np.abs(codes[1]) % 2) == {0}                     # .5 ties went to even
        assert np.abs(codes[2]).max() == QMAX and (np.abs(codes[2]) >= 126).all()


def test_rows_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((17, 8))
    qw = torch.zeros((8, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="up to 16 rows"):
        pm.psram_matmul_int32_rows(x, torch.ones((17, 1)), qw)
    with pytest.raises(TypeError):
        pm.psram_matmul_int32_rows(x[:4].half(), torch.ones((4, 1)).half(), qw)
    with pytest.raises(TypeError):
        pm.psram_matmul_int32_rows(x[:4], torch.ones((4, 1), dtype=torch.bfloat16), qw)
    with pytest.raises(ValueError):
        pm.psram_matmul_int32_rows(x[:4], torch.ones((4, 1)), qw[:7])


@pytest.mark.parametrize("n", [64, 30])
def test_epilogue_bf16_equals_f32_rounded(n):
    """The epilogue written in bf16 is the f32 result rounded once
    (``.to(torch.bfloat16)``), at N % 4 = 0 and N % 4 != 0."""
    rng = np.random.default_rng(n)
    m, k = 8, 1024
    acc = torch.tensor(rng.integers(-(QMAX ** 2) * k, QMAX ** 2 * k, (m, n)), dtype=torch.int32)
    sx = torch.tensor(rng.uniform(1e-3, 1.0, (m, 1)), dtype=torch.float32)
    sw = torch.tensor(rng.uniform(1e-3, 1.0, (1, n)), dtype=torch.float32)
    f32 = pm.psram_adc_epilogue(acc, sx, sw, k)
    bf16 = pm.psram_adc_epilogue(acc, sx, sw, k, out_dtype=torch.bfloat16)
    assert f32.dtype == torch.float32 and bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, f32.to(torch.bfloat16))
    with pytest.raises(TypeError):
        pm.psram_adc_epilogue(acc, sx, sw, k, out_dtype=torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_four_slices_then_epilogue_equal_reference(dtype):
    """M = 8, K = 256, N = 64: four K slices through the rows slice's plain
    version, their int32 sums added, then the epilogue on the whole K, equal
    to the reference's ``quantize_symmetric`` over the whole K followed by
    ``psram_matmul_ref``, op by op."""
    m, k, n, ways = 8, 256, 64, 4
    rng = np.random.default_rng(7)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    with jax.disable_jit():
        jx = jnp.asarray(x).astype(jdtype)
        qx, jsx = jq_quantize(jx, axis=-1)
        qw, jsw = jq_quantize(jnp.asarray(w), axis=0)
        want = np.asarray(psram_matmul_ref(qx, qw, jsx, jsw))
    xt = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(dtype)
    # the scale over the whole K, as the all-reduced maximum gives it
    sx = symmetric_scale(xt.abs().amax(dim=-1, keepdim=True))
    assert torch.equal(sx.float(), torch.tensor(np.asarray(jsx.astype(jnp.float32))))
    qwt = torch.tensor(np.asarray(qw))
    sw = torch.tensor(np.asarray(jsw), dtype=torch.float32).reshape(1, n)
    ks = k // ways
    acc = sum(pm.psram_matmul_int32_rows(xt[:, i * ks:(i + 1) * ks].contiguous(), sx,
                                         qwt[i * ks:(i + 1) * ks].contiguous())
              for i in range(ways))
    got = pm.psram_adc_epilogue(acc.to(torch.int32), sx.float(), sw, k)
    assert torch.equal(got, torch.tensor(want))
    assert torch.equal(pm.psram_adc_epilogue(acc.to(torch.int32), sx.float(), sw, k,
                                             out_dtype=torch.bfloat16),
                       torch.tensor(want).to(torch.bfloat16))
