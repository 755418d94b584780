"""The port's encoder-decoder family (``repro_torch.models.encdec``), the
write-through decode (``layers.attention_decode``) and serving with frames,
held against the JAX reference on the CPU.

Reduced (f32) seamless-m4t-large-v2 with the reference's own params carried
over by ``convert.model_params``; the same numpy-seeded frames and tokens go
through both packages. Tolerances, each with its reason: within 1e-5 of
each output's max against the reference (f32 matmuls, sums in another
order); decode against the port's own forward within the decode-vs-forward
2e-2 of ``tests/test_models.py``; greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models.registry import get_config as jget_config
from repro.serve import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.models import encdec, layers
from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import get_module
from repro_torch.serve import ServeEngine, make_prefill, make_serve_step

ARCH = "seamless_m4t_large_v2"
B, FRAMES, PROMPT, STEPS = 2, 20, 6, 3


def _port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**dataclasses.asdict(jcfg))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rel=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * top, (err, top)


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config(ARCH).reduced()
    jparams = jencdec.init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(21)
    frames = rng.standard_normal((B, FRAMES, jcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab_size, (B, PROMPT + STEPS), dtype=np.int32)
    cfg = _port_cfg(jcfg)
    params = convert.model_params(_np_tree(jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params, frames, toks


def test_param_layout(model):
    """Lists of per-layer dicts where the reference stacks; frame_proj and
    the head plain tensors."""
    _, _, cfg, params, _, _ = model
    assert get_module(cfg) is encdec
    assert len(params["encoder"]) == cfg.enc_layers and len(params["decoder"]) == cfg.dec_layers
    assert set(params["decoder"][0]) == {"pre_norm", "self_attn", "cross_norm", "cross_attn",
                                         "mlp_norm", "mlp"}
    own = encdec.init(0, cfg, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), own) == \
        jax.tree.map(lambda t: tuple(t.shape), params)


def test_encode_matches_reference(model):
    jcfg, jparams, cfg, params, frames, _ = model
    got = encdec.encode(params, torch.tensor(frames), cfg)
    _close(got, jencdec.encode(jparams, jnp.asarray(frames), jcfg))


def test_prefill_and_decode_match_reference(model):
    """The prefill's logits and cache (self k/v padded to the cache length,
    cross k/v the encoder's), then three decode steps from the reference's
    own cache: each step's logits, the self cache written in place, the
    cross cache never touched."""
    jcfg, jparams, cfg, params, frames, toks = model
    cache_len = PROMPT + STEPS + 1
    jl, jc = jencdec.prefill(jparams, jnp.asarray(frames), jnp.asarray(toks[:, :PROMPT]), jcfg,
                             cache_len)
    lt, ct = encdec.prefill(params, torch.tensor(frames), torch.tensor(toks[:, :PROMPT]), cfg,
                            cache_len)
    _close(lt, jl)
    want = convert.model_cache(_np_tree(jc), device="cpu")
    assert len(ct) == cfg.dec_layers
    for got_l, want_l in zip(ct, want):
        assert tuple(got_l["self"]["k"].shape) == (B, cache_len, cfg.n_kv_heads, cfg.head_dim)
        assert tuple(got_l["cross"]["k"].shape) == (B, FRAMES, cfg.n_kv_heads, cfg.head_dim)
        for part in ("self", "cross"):
            for name in ("k", "v"):
                _close(got_l[part][name], want_l[part][name].numpy())
    cache = want
    cross = [c["cross"]["k"].clone() for c in cache]
    self_k = [c["self"]["k"] for c in cache]
    for i in range(STEPS):
        jl, jc = jencdec.decode_step(jparams, jc, jnp.asarray(toks[:, PROMPT + i]),
                                     jnp.int32(PROMPT + i), jcfg)
        lt, cache = encdec.decode_step(params, cache, torch.tensor(toks[:, PROMPT + i]),
                                       PROMPT + i, cfg)
        _close(lt, jl)
    for c, k0, kc, want_l in zip(cache, self_k, cross,
                                 convert.model_cache(_np_tree(jc), device="cpu")):
        assert c["self"]["k"] is k0
        assert torch.equal(c["cross"]["k"], kc)
        _close(c["self"]["k"], want_l["self"]["k"].numpy())
        _close(c["self"]["v"], want_l["self"]["v"].numpy())


def test_decode_matches_forward():
    """The port's twin of the reference's test_encdec_decode_matches_forward
    on the port's own random params."""
    cfg = _port_cfg(jget_config(ARCH).reduced())
    params = encdec.init(0, cfg, device="cpu")
    rng = np.random.default_rng(22)
    frames = torch.tensor(rng.standard_normal((B, 12, cfg.d_model)).astype(np.float32))
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (B, 8)))
    full = encdec.forward(params, frames, toks, cfg)
    logits, cache = encdec.prefill(params, frames, toks[:, :6], cfg, cache_len=8)
    torch.testing.assert_close(logits, full[:, 5], rtol=2e-2, atol=2e-2)
    for t in (6, 7):
        logits, cache = encdec.decode_step(params, cache, toks[:, t], t, cfg)
        torch.testing.assert_close(logits, full[:, t], rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module")
def attn():
    jcfg = jget_config(ARCH).reduced()
    jp = jlayers.init_params(jax.random.PRNGKey(5), jlayers.attention_defs(jcfg))
    rng = np.random.default_rng(23)
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    kv = {name: rng.standard_normal((B, 9, jcfg.n_kv_heads, jcfg.head_dim)).astype(np.float32)
          for name in ("k", "v")}
    return jcfg, jp, _port_cfg(jcfg), jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jp), \
        x, kv


def _torch_kv(kv):
    return {name: torch.tensor(a) for name, a in kv.items()}


def test_attention_decode_cross_matches_reference(attn):
    """Cross attention: non-rotary, every position valid, nothing written."""
    jcfg, jp, cfg, p, x, kv = attn
    cache = _torch_kv(kv)
    y, out = layers.attention_decode(p, torch.tensor(x), cfg, cache, 4, cross=True)
    jy, _ = jlayers.attention_decode(jp, jnp.asarray(x), jcfg, kv, jnp.int32(4), cross=True)
    _close(y, jy)
    assert out is cache and all(np.array_equal(cache[n].numpy(), kv[n]) for n in kv)


def test_attention_decode_self_matches_reference(attn):
    """The self branch: the new token written in place at ``cache_pos`` (the
    reference returns the updated copy)."""
    jcfg, jp, cfg, p, x, kv = attn
    pos = 4
    jy, jc = jlayers.attention_decode(jp, jnp.asarray(x), jcfg, kv, jnp.int32(pos))
    cache = _torch_kv(kv)
    y, out = layers.attention_decode(p, torch.tensor(x), cfg, cache, pos)
    _close(y, jy)
    assert out is cache
    for name in ("k", "v"):
        _close(out[name], jc[name])
    assert not np.array_equal(cache["k"][:, pos].numpy(), kv["k"][:, pos])


@pytest.fixture(scope="module")
def served():
    jcfg = jget_config(ARCH).reduced()
    jparams = jencdec.init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(25)
    prompts = rng.integers(2, jcfg.vocab_size, (B, 8), dtype=np.int32)
    frames = rng.standard_normal((B, 32, jcfg.d_model)).astype(np.float32)
    eng = JServeEngine(jcfg, jparams, max_len=12)
    toks = np.asarray(eng.generate(jnp.asarray(prompts), 8, 4, frames=jnp.asarray(frames)))
    cfg = _port_cfg(jcfg)
    return cfg, convert.model_params(_np_tree(jparams), cfg, device="cpu"), prompts, frames, toks


def test_generate_with_frames_equals_reference(served):
    cfg, params, prompts, frames, want = served
    eng = ServeEngine(cfg, params, max_len=12, device="cpu")
    got = eng.generate(torch.tensor(prompts), 8, 4, frames=torch.tensor(frames))
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_without_frames_raises(served):
    """The encoder-decoder needs its frames; it has no delta-form step (the
    paged serve loop is for decoder-only families), as in the reference."""
    cfg, params, prompts, frames, _ = served
    eng = ServeEngine(cfg, params, max_len=12, device="cpu")
    with pytest.raises(ValueError, match="frames"):
        eng.generate(torch.tensor(prompts), 8, 4)
    with pytest.raises(ValueError, match="delta-form"):
        make_serve_step(cfg, deltas=True)
    logits, cache = make_prefill(cfg, 12)(params, torch.tensor(frames), torch.tensor(prompts))
    assert tuple(logits.shape) == (B, cfg.padded_vocab) and len(cache) == cfg.dec_layers
