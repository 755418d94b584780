"""Flash attention of the port held against the JAX reference on the CPU.

The same numpy-seeded q/k/v go through the reference's Pallas kernel (run
in interpret mode, as its own tests run it), its ``attention_ref`` oracle,
and the port's plain version (what the wrapper takes for CPU tensors; what
the CUDA kernel is held against on the card). Tolerances:

* f32: the plain version computes an exact softmax where the kernel runs an
  online one, so the two differ by float reassociation only — within 1e-5 of
  max |out|. Against ``attention_ref`` the reference's own 2e-3.
* bf16: the reference's own 3e-2 (its kernel against the f32 oracle).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models.config import ArchConfig as JArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_torch
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _sdpa_chunked

CASES = [  # the five cases of the reference's test_flash_vs_ref
    (2, 4, 4, 256, 64, True, 0.0),
    (2, 4, 2, 256, 64, True, 0.0),    # GQA
    (1, 8, 1, 128, 32, True, 0.0),    # MQA
    (2, 4, 4, 256, 64, False, 0.0),
    (2, 4, 2, 128, 64, True, 50.0),   # softcap (gemma2-style)
]
IDS = ["mha", "gqa", "mqa", "noncausal", "softcap"]


def _qkv(b, h, hkv, sq, skv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32))


def _t(*arrays):
    return tuple(torch.tensor(a) for a in arrays)


@pytest.mark.parametrize("b,h,hkv,s,d,causal,softcap", CASES, ids=IDS)
def test_plain_version_matches_interpreted_kernel_and_oracle(b, h, hkv, s, d, causal, softcap):
    q, k, v = _qkv(b, h, hkv, s, s, d, seed=s + h + hkv)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kernel = np.asarray(j_flash(jq, jk, jv, causal=causal, softcap=softcap,
                                bq=64, bkv=64, interpret=True))
    oracle = np.asarray(jref.attention_ref(jq, jk, jv, causal=causal, softcap=softcap))
    tq, tk, tv = _t(q, k, v)
    got = flash_attention_torch(tq, tk, tv, causal=causal, softcap=softcap).numpy()
    top = float(np.abs(kernel).max())
    assert np.abs(got - kernel).max() <= 1e-5 * top
    np.testing.assert_allclose(got, oracle, rtol=2e-3, atol=2e-3)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        flash_attention(tq, tk, tv, causal=causal, softcap=softcap).numpy(), got)
    # the port's oracle is the reference's oracle
    np.testing.assert_allclose(
        tref.attention_ref(tq, tk, tv, causal=causal, softcap=softcap).numpy(), oracle,
        rtol=1e-5, atol=1e-5 * top)


def test_plain_version_bf16():
    q, k, v = _qkv(1, 2, 2, 128, 128, 64, seed=3)
    bf = jnp.bfloat16
    kernel = j_flash(jnp.asarray(q).astype(bf), jnp.asarray(k).astype(bf),
                     jnp.asarray(v).astype(bf), causal=True, bq=64, bkv=64, interpret=True)
    oracle = np.asarray(jref.attention_ref(*map(jnp.asarray, (q, k, v)), causal=True))
    tq, tk, tv = (t.to(torch.bfloat16) for t in _t(q, k, v))
    got = flash_attention_torch(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    got = got.to(torch.float32).numpy()
    np.testing.assert_allclose(got, np.asarray(kernel, dtype=np.float32), rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got, oracle, rtol=3e-2, atol=3e-2)


def test_noncausal_unequal_lengths_and_explicit_scale():
    """Non-causal attention takes Skv != Sq, as the reference kernel does."""
    q, k, v = _qkv(1, 4, 2, 64, 192, 32, seed=5)
    kernel = np.asarray(j_flash(*map(jnp.asarray, (q, k, v)), causal=False, scale=0.2,
                                bq=64, bkv=64, interpret=True))
    got = flash_attention_torch(*_t(q, k, v), causal=False, scale=0.2, bq=64, bkv=64).numpy()
    assert np.abs(got - kernel).max() <= 1e-5 * float(np.abs(kernel).max())


def test_op_dispatch():
    q, k, v = _t(*_qkv(1, 2, 1, 64, 64, 16, seed=7))
    plain = flash_attention_torch(q, k, v)
    for low in ("auto", "torch"):
        assert torch.equal(kops.flash_attention_op(q, k, v, lowering=low), plain)
    assert torch.allclose(kops.flash_attention_op(q, k, v, lowering="ref"), plain,
                          rtol=2e-3, atol=2e-3)
    # a lowering outside the table names the op, as the reference's does
    with pytest.raises(RuntimeError, match="flash_attention.*no dispatch entry.*implemented"):
        kops.flash_attention_op(q, k, v, lowering="xla")
    # the CUDA kernel never runs the plain version for a CPU tensor
    with pytest.raises(ValueError, match="CUDA device"):
        kops.flash_attention_op(q, k, v, lowering="cuda")


@pytest.mark.parametrize("sq,skv", [(64, 128), (128, 64)], ids=["sq<skv", "sq>skv"])
def test_causal_unequal_lengths_top_left(sq, skv):
    """Causal attention with Sq != Skv is top-left aligned, as the reference
    kernel's mask ``rows >= cols`` on global indices: row i sees keys 0..i."""
    q, k, v = _qkv(1, 2, 2, sq, skv, 16, seed=sq + skv)
    kernel = np.asarray(j_flash(*map(jnp.asarray, (q, k, v)), causal=True,
                                bq=64, bkv=64, interpret=True))
    tq, tk, tv = _t(q, k, v)
    got = flash_attention_torch(tq, tk, tv, causal=True, bq=64, bkv=64).numpy()
    assert np.isfinite(got).all() and got.shape == (1, 2, sq, 16)
    assert np.abs(got - kernel).max() <= 1e-5 * float(np.abs(kernel).max())
    np.testing.assert_array_equal(
        flash_attention(tq, tk, tv, causal=True, bq=64, bkv=64).numpy(), got)


@pytest.mark.parametrize("shape_q,shape_kv,causal,match", [
    ((1, 3, 64, 16), (1, 2, 64, 16), True, "multiple of kv heads"),
    ((1, 2, 192, 16), (1, 2, 192, 16), True, "multiple of bq"),     # 192 % 128
    ((1, 2, 128, 16), (1, 2, 200, 16), False, "multiple of bq"),    # 200 % 128
])
def test_shapes_the_reference_refuses_raise(shape_q, shape_kv, causal, match):
    q = torch.zeros(shape_q)
    kv = torch.zeros(shape_kv)
    with pytest.raises(ValueError, match=match):
        flash_attention(q, kv, kv, causal=causal)


def test_plain_version_matches_model_chunked_attention():
    """The port's twin of the reference's
    test_flash_matches_model_chunked_attention: the plain flash version on
    (B, H, S, D) equals the model's chunked attention on (B, S, H, D)."""
    cfg = ArchConfig(name="t", attn_chunk=64)
    assert cfg == ArchConfig(**{f: getattr(JArchConfig(name="t", attn_chunk=64), f)
                                for f in cfg.__dataclass_fields__})
    q, k, v = _t(*_qkv(2, 4, 4, 256, 256, 64, seed=9))
    got = flash_attention_torch(q, k, v, causal=True)
    want = _sdpa_chunked(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), cfg,
                         causal=True, window=0)
    np.testing.assert_allclose(got.numpy(), want.transpose(1, 2).numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("d", [48, 80, 96, 160, 192])
def test_head_dims_outside_the_kernels_run_padded(d):
    """A head dim the CUDA kernels are not built for runs zero-padded to the
    next one they are (up to 256), with the scale of the true D: the plain
    version through that padding is within 1e-5 of max |out| of the
    interpreted Pallas kernel at the true D, as the plain version at D is.
    Above 128 the padding goes to 256, and above 256 to the slab kernel's
    multiple of 64; no head dim is refused."""
    from repro_torch.kernels.flash_attention import (kernel_head_dim, kernel_route,
                                                     padded_attention)

    q, k, v = _qkv(1, 4, 2, 128, 128, d, seed=d)
    kernel = np.asarray(j_flash(*map(jnp.asarray, (q, k, v)), causal=True,
                                bq=64, bkv=64, interpret=True))
    top = float(np.abs(kernel).max())
    tq, tk, tv = _t(q, k, v)
    plain = flash_attention_torch(tq, tk, tv, causal=True).numpy()
    padded = padded_attention(flash_attention_torch, tq, tk, tv, causal=True)
    assert kernel_head_dim(d) > d and tuple(padded.shape) == q.shape
    assert np.abs(plain - kernel).max() <= 1e-5 * top
    assert np.abs(padded.numpy() - kernel).max() <= 1e-5 * top
    assert [kernel_head_dim(x) for x in (160, 256, 257, 320, 500)] == [256, 256, 320, 320, 512]
    assert kernel_route(d, torch.bfloat16) == "wgmma" and kernel_route(d, torch.float16) == "f32"
    assert kernel_route(320, torch.bfloat16) == "slab" and kernel_route(256, torch.float32) == "f32"


@pytest.mark.parametrize("d", [256, 320, 512])
def test_wide_head_dims_match_interpreted_kernel(d):
    """D = 256 (the bf16 and f32 kernels' widest instantiation) and D > 256
    (the slab kernel's) at softcap 50, GQA and causal Sq != Skv (top-left
    aligned): the plain version, at the head dim the card runs, within 1e-5
    of max |out| of the interpreted Pallas kernel; the wrapper takes the
    plain version for CPU tensors."""
    from repro_torch.kernels.flash_attention import kernel_head_dim, padded_attention

    assert kernel_head_dim(d) == d
    for sq, skv in ((64, 128), (128, 64)):
        q, k, v = _qkv(1, 4, 2, sq, skv, d, seed=d + sq)
        kernel = np.asarray(j_flash(*map(jnp.asarray, (q, k, v)), causal=True, softcap=50.0,
                                    bq=64, bkv=64, interpret=True))
        top = float(np.abs(kernel).max())
        tq, tk, tv = _t(q, k, v)
        got = padded_attention(flash_attention_torch, tq, tk, tv, causal=True, softcap=50.0)
        assert np.isfinite(got.numpy()).all() and tuple(got.shape) == (1, 4, sq, d)
        assert np.abs(got.numpy() - kernel).max() <= 1e-5 * top
        np.testing.assert_array_equal(
            flash_attention(tq, tk, tv, causal=True, softcap=50.0).numpy(), got.numpy())


def test_fp16_is_computed_in_f32_and_rounded_once():
    """fp16 q/k/v: the plain version (what the card's f32-staged kernel is
    held against) is the f32 attention of the fp16 values rounded once to
    fp16, and within one fp16 ulp of each element plus 1e-5 of max |out| of
    the interpreted Pallas kernel, which also computes in f32 and rounds its
    result to fp16 once."""
    q, k, v = (a.astype(np.float16) for a in _qkv(2, 4, 2, 128, 128, 64, seed=16))
    kernel = np.asarray(j_flash(*map(jnp.asarray, (q, k, v)), causal=True,
                                bq=64, bkv=64, interpret=True))
    assert kernel.dtype == np.float16
    tq, tk, tv = _t(q, k, v)
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.float16
    f32 = flash_attention_torch(tq.float(), tk.float(), tv.float(), causal=True)
    assert torch.equal(got, f32.to(torch.float16))
    got, kernel = got.numpy().astype(np.float32), kernel.astype(np.float32)
    ulp = np.spacing(np.abs(kernel).astype(np.float16)).astype(np.float32)
    assert (np.abs(got - kernel) <= ulp + 1e-5 * float(np.abs(kernel).max())).all()
