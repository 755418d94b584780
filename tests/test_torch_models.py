"""The port's model families held against the JAX reference on the CPU.

Reduced (f32) forms of every config of ``ARCH_IDS``: dense (M-RoPE's qwen2-vl
among them), MoE, SSM, hybrid and encoder-decoder; the reference's own params
(``init(PRNGKey(0))``) are carried over by ``convert.model_params`` and the
same numpy-seeded tokens (and, for the encoder-decoder, frames) go through
both packages. Tolerances, each with its reason:

* exact projections: logits within 1e-5 of max |logit| (f32 matmuls, sums in
  another order); caches within 1e-5 of each leaf's max (|k|, |v|, an SSM
  layer's state and conv window);
* pSRAM projections (``psram_projections``: weights quantized on the fly;
  ``psram_stored_int8``: the reference's own int8 words): the ADC transfer
  and the integer sums are exact, but the jitted reference's per-row
  activation scales sit one f32 ulp from eager division on ~5% of rows
  (ROADMAP Queue C), which moves a code by one where the quotient lies on a
  rounding boundary. Codes one apart are counted (at most 1e-3 of them) and
  the logits held within 1e-3 of max |logit|.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import photonic_layer as jpl
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.registry import get_config as jget_config
from repro.models.registry import get_module as jget_module
from repro_torch import convert
from repro_torch.core import photonic_layer as tpl
from repro_torch.core.quantization import quantize_symmetric
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import ARCH_IDS, get_config, get_module

B, PROMPT, STEPS = 2, 12, 3


def _port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**dataclasses.asdict(jcfg))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(cfg, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, PROMPT + STEPS),
                                                dtype=np.int32)


ENC_FRAMES = 20   # the encoder-decoder's stub frames a row (not a multiple of anything)


def _frames(cfg, seed=2):
    """The encoder's input for the encoder-decoder family, else None."""
    if cfg.family != "encdec":
        return None
    return np.random.default_rng(seed).standard_normal((B, ENC_FRAMES, cfg.d_model)) \
        .astype(np.float32)


def _lead(frames, as_tensor):
    """The leading arguments of forward / prefill: ``(frames,)`` for the
    encoder-decoder family, else ``()``."""
    return () if frames is None else (as_tensor(frames),)


@functools.lru_cache(maxsize=None)
def reference_run(arch, psram=False, stored=False):
    """The reference's forward, prefill and three decode steps on one set of
    params and tokens (computed once per module process)."""
    jcfg = dataclasses.replace(jget_config(arch).reduced(), psram_projections=psram,
                               psram_stored_int8=stored)
    mod = jget_module(jcfg)
    params = mod.init(jax.random.PRNGKey(0), jcfg)
    toks, frames = _tokens(jcfg), _frames(jcfg)
    lead = _lead(frames, jnp.asarray)
    out = {"cfg": jcfg, "params": _np_tree(params), "tokens": toks, "frames": frames}
    out["forward"] = np.asarray(mod.forward(params, *lead, jnp.asarray(toks), jcfg))
    if psram:
        return out
    logits, cache = mod.prefill(params, *lead, jnp.asarray(toks[:, :PROMPT]), jcfg,
                                cache_len=PROMPT + STEPS + 1)
    out["prefill"] = (np.asarray(logits), _np_tree(cache))
    steps = []
    for i in range(STEPS):
        logits, cache = mod.decode_step(params, cache, jnp.asarray(toks[:, PROMPT + i]),
                                        jnp.int32(PROMPT + i), jcfg)
        steps.append(np.asarray(logits))
    out["decode"] = (steps, _np_tree(cache))
    return out


def _port(run):
    """(cfg, params, tokens, leading args, module) of the port for a run."""
    cfg = _port_cfg(run["cfg"])
    return (cfg, convert.model_params(run["params"], cfg, device="cpu"),
            torch.tensor(run["tokens"]), _lead(run["frames"], torch.tensor), get_module(cfg))


def _close(got, want, rel=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * top, (err, top)


def _caches_close(port_cache, ref_tree):
    want = convert.model_cache(ref_tree, device="cpu")
    assert len(port_cache) == len(want)
    for g_got, g_want in zip(port_cache, want):
        assert set(g_got) == set(g_want)
        for key in g_want:
            assert set(g_got[key]) == set(g_want[key])
            for name, leaf in g_want[key].items():
                assert g_got[key][name].shape == leaf.shape
                assert g_got[key][name].dtype == leaf.dtype
                _close(g_got[key][name], leaf.numpy())


def _first_kv(cache):
    """The first attention layer's k cache of a model's cache."""
    if "self" in cache[0]:
        return cache[0]["self"]["k"]
    return next(layer["k"] for layer in cache[0].values() if "k" in layer)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_is_the_reference_config(arch):
    jcfg = jget_config(arch)
    cfg = get_config(arch)
    assert cfg == _port_cfg(jcfg)
    assert cfg.reduced() == _port_cfg(jcfg.reduced())
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference(arch):
    run = reference_run(arch)
    cfg, params, toks, lead, mod = _port(run)
    got = mod.forward(params, *lead, toks, cfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == run["forward"].shape
    _close(got, run["forward"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_matches_reference(arch):
    run = reference_run(arch)
    cfg, params, toks, lead, mod = _port(run)
    logits, cache = mod.prefill(params, *lead, toks[:, :PROMPT], cfg,
                                cache_len=PROMPT + STEPS + 1)
    _close(logits, run["prefill"][0])
    _caches_close(cache, run["prefill"][1])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_steps_match_reference(arch):
    """Three decode steps from the reference's own prefill cache: logits of
    every step and the cache they wrote (gemma2's local layers run past their
    window of 8; SSM layers replace their state and conv window; the
    encoder-decoder's cross cache is left as it was)."""
    run = reference_run(arch)
    cfg, params, toks, _, mod = _port(run)
    cache = convert.model_cache(run["prefill"][1], device="cpu")
    for i in range(STEPS):
        logits, cache = mod.decode_step(params, cache, toks[:, PROMPT + i], PROMPT + i, cfg)
        _close(logits, run["decode"][0][i])
    _caches_close(cache, run["decode"][1])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_forward(arch):
    """The port's twin of the reference's test_decode_matches_forward (and
    test_encdec_decode_matches_forward), on the port's own random params:
    prefill + decode == forward (the SSM layers' recurrent step against
    their chunked scan), and a per-row ``(B,)`` cache position decodes like
    the scalar one (the encoder-decoder's step, like the reference's, takes
    a scalar only)."""
    cfg = get_config(arch).reduced()
    mod = get_module(cfg)
    params = mod.init(0, cfg, device="cpu")
    toks = torch.tensor(_tokens(cfg, seed=2)[:, :10])
    lead = _lead(_frames(cfg, seed=3), torch.tensor)
    full = mod.forward(params, *lead, toks, cfg)
    logits_p, cache = mod.prefill(params, *lead, toks[:, :8], cfg, cache_len=12)
    torch.testing.assert_close(logits_p, full[:, 7], rtol=2e-2, atol=2e-2)
    lg1, cache = mod.decode_step(params, cache, toks[:, 8], 8, cfg)
    torch.testing.assert_close(lg1, full[:, 8], rtol=2e-2, atol=2e-2)
    pos = 9 if cfg.family == "encdec" else torch.tensor([9, 9])
    lg2, cache = mod.decode_step(params, cache, toks[:, 9], pos, cfg)
    torch.testing.assert_close(lg2, full[:, 9], rtol=2e-2, atol=2e-2)
    if cfg.family != "ssm":
        assert float(_first_kv(cache)[:, 9].abs().max()) > 0


def test_sliding_window_masks_past():
    """A local layer attends to the last ``sliding_window`` positions only:
    changing a token outside every window leaves the last position's output
    as it was, and the layer equals the reference's on the same params."""
    jcfg = dataclasses.replace(jget_config("gemma2_27b").reduced(), sliding_window=4)
    cfg = _port_cfg(jcfg)
    jp = jlayers.init_params(jax.random.PRNGKey(3), jlayers.attention_defs(jcfg))
    p = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jp)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 12, cfg.d_model)).astype(np.float32)
    x2 = x.copy()
    x2[0, 0] += 1.0
    pos = np.arange(12, dtype=np.int32)[None]
    y1, _ = tlayers.attention_fwd(p, torch.tensor(x), cfg, torch.tensor(pos), layer_local=True)
    y2, _ = tlayers.attention_fwd(p, torch.tensor(x2), cfg, torch.tensor(pos), layer_local=True)
    assert torch.equal(y1[0, 4:], y2[0, 4:])       # positions >= 4 do not see position 0
    assert not torch.equal(y1[0, :4], y2[0, :4])
    jy, _ = jlayers.attention_fwd(jp, jnp.asarray(x), jcfg, jnp.asarray(pos), layer_local=True)
    _close(y1, np.asarray(jy))


def test_partial_rope_passthrough():
    """chatglm3 2d-RoPE: the unrotated half passes through unchanged, and
    the rotated half equals the reference's."""
    jcfg = jget_config("chatglm3_6b").reduced()
    x = np.random.default_rng(5).standard_normal((1, 5, 2, 16)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)[None]
    y = tlayers.apply_rope(torch.tensor(x), torch.tensor(pos), _port_cfg(jcfg)).numpy()
    np.testing.assert_array_equal(y[..., 8:], x[..., 8:])
    assert np.abs(y[..., :8] - x[..., :8]).max() > 1e-5
    want = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), jcfg))
    np.testing.assert_allclose(y, want, rtol=1e-6, atol=1e-6)


def test_chunked_attention_matches_einsum():
    cfg = get_config("granite_8b").reduced()
    params = transformer.init(0, cfg, device="cpu")
    toks = torch.tensor(_tokens(cfg, seed=6)[:, :12].repeat(2, axis=1)[:, :24])
    a = transformer.forward(params, toks, cfg)
    b = transformer.forward(params, toks, dataclasses.replace(cfg, attention_impl="chunked",
                                                              attn_chunk=8))
    torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ["granite_8b", "gemma2_27b", "granite_moe_1b_a400m",
                                  "mamba2_370m"])
@pytest.mark.parametrize("stored", [False, True], ids=["on_the_fly", "stored_int8"])
def test_psram_projection_forward_matches_reference(arch, stored):
    """pSRAM projections through kernel 2's plain version on the CPU: every
    attention and MLP projection, or mamba2's ``in_proj`` and ``out_proj``."""
    run = reference_run(arch, psram=True, stored=stored)
    cfg, params, toks, _, _ = _port(run)
    mixer = params["blocks"][0]["layer0"]["mixer"]
    first = mixer["wq"] if "wq" in mixer else mixer["in_proj"]
    if stored:
        assert first["q"].dtype == torch.int8 and first["scale"].dtype == torch.float32
        assert cfg.family != "ssm" or mixer["out_proj"]["q"].dtype == torch.int8
    got = transformer.forward(params, toks, cfg)
    assert bool(torch.isfinite(got).all())
    _close(got, run["forward"], rel=1e-3)
    # the activation codes of layer 0's first projections (wq/wk/wv, or
    # in_proj): the port's eager quantization against the reference's jitted
    # one (measured: none of 1920 codes apart)
    jcfg, jp = run["cfg"], run["params"]

    @jax.jit
    def ref_codes(p, t):
        pre = jax.tree.map(lambda a: a[0], p["blocks"]["layer0"]["pre_norm"])
        x0 = jlayers.rmsnorm(pre, jtransformer._embed(p, t, jcfg), jcfg.norm_eps)
        return jpl.quantize_symmetric(x0.reshape(-1, jcfg.d_model), axis=-1)[0]

    want = np.asarray(ref_codes(jp, jnp.asarray(run["tokens"]))).astype(np.int32)
    x0 = tlayers.rmsnorm(params["blocks"][0]["layer0"]["pre_norm"],
                         transformer._embed(params, toks, cfg), cfg.norm_eps)
    codes = quantize_symmetric(x0.reshape(-1, cfg.d_model), axis=-1)[0]
    d = np.abs(codes.numpy().astype(np.int32) - want)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def test_psram_linear_bf16_codes_and_output():
    """A bf16 activation: the per-row scale is a bf16 value and ``x / scale``
    a bf16 division, in both packages — codes one apart at most, on at most
    1e-3 of the elements (measured: none), scales equal. The f32 output is
    bit-equal to the reference run op by op. Jitted, XLA keeps the scale
    unrounded (f32) in its fusion for the dequant product ``sx * w_scale``
    (it rounds it to bf16 only for the division), so against the jitted
    reference the output differs by at most that rounding: 2^-8 relative."""
    rng = np.random.default_rng(7)
    x32 = rng.standard_normal((3, 40, 64)).astype(np.float32)
    w32 = (rng.standard_normal((64, 48)) / 8).astype(np.float32)
    jx = jnp.asarray(x32).astype(jnp.bfloat16)
    jprog = jpl.program_weights(jnp.asarray(w32))
    qj, sj = jax.jit(lambda a: jpl.quantize_symmetric(a, axis=-1))(jx)
    assert qj.dtype == jnp.int8 and sj.dtype == jnp.bfloat16
    x = convert._array_tensor(np.asarray(jx), "cpu")
    assert x.dtype == torch.bfloat16
    qt, st = quantize_symmetric(x, axis=-1)
    assert st.dtype == torch.bfloat16
    d = np.abs(qt.numpy().astype(np.int32) - np.asarray(qj).astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    np.testing.assert_array_equal(st.to(torch.float32).numpy(),
                                  np.asarray(sj).astype(np.float32))
    prog = {k: convert._array_tensor(np.asarray(v), "cpu") for k, v in jprog.items()}
    got = tpl.psram_linear(x, prog).numpy()
    with jax.disable_jit():
        eager = np.asarray(jpl.psram_linear(jx, jprog))
        wrap = np.asarray(jpl.psram_linear(jx, jprog, adc_bits=4, saturate=False))
    np.testing.assert_array_equal(got, eager)
    jitted = np.asarray(jpl.psram_linear(jx, jprog))
    assert (np.abs(got - jitted) <= 2.0 ** -8 * np.abs(jitted) + 1e-6).all()
    # the exact product on the CPU and a wrapping ADC when asked
    np.testing.assert_array_equal(
        tpl.psram_linear(x, prog, adc_bits=4, saturate=False).numpy(), wrap)


def test_mrope_angles_are_the_reference_bits():
    """M-RoPE's angles (``pos`` of shape (3, B, S), the h stream diverging
    from t and w) equal, bit for bit, the reference's one-hot contraction
    ``einsum("tbs,ti->bsi", pos, one_hot(stream).T * inv)`` run by JAX."""
    jcfg = jget_config("qwen2_vl_7b").reduced()
    rot = jcfg.head_dim
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (3, 2, 7)).copy()
    pos[1] *= 3
    pos[2] += 5
    sec = jnp.cumsum(jnp.array((0,) + tuple(jcfg.mrope_sections)))
    stream = jnp.searchsorted(sec[1:], jnp.arange(rot // 2), side="right")
    inv = jcfg.rope_theta ** (-jnp.arange(0, rot, 2, dtype=jnp.float32) / rot)
    want = np.asarray(jnp.einsum("tbs,t i->bsi", jnp.asarray(pos).astype(jnp.float32),
                                 jax.nn.one_hot(stream, 3, dtype=jnp.float32).T * inv[None, :]))
    got = tlayers._rope_angles(torch.tensor(pos), rot, _port_cfg(jcfg))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert tlayers._mrope_streams(tuple(jcfg.mrope_sections), rot // 2,
                                  torch.device("cpu")).tolist() == np.asarray(stream).tolist()


@pytest.mark.parametrize("streams", ["text", "h_diverges"])
def test_mrope_matches_reference(streams):
    """``apply_rope`` with M-RoPE (the reference's test_mrope_position_streams_differ
    inputs): text positions (t = h = w) and an h stream that diverges.
    Equal to the reference's within 1e-6: the angles are its bits, but
    PyTorch's CPU cos/sin and XLA's differ by up to one f32 ulp (so does
    plain RoPE's); a diverging h stream changes the output."""
    jcfg = jget_config("qwen2_vl_7b").reduced()
    x = np.random.default_rng(8).standard_normal((1, 6, 2, 16)).astype(np.float32)
    text = np.broadcast_to(np.arange(6, dtype=np.int32), (3, 1, 6)).copy()
    pos = text.copy()
    if streams == "h_diverges":
        pos[1] *= 3
    cfg = _port_cfg(jcfg)
    got = tlayers.apply_rope(torch.tensor(x), torch.tensor(pos), cfg).numpy()
    want = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), jcfg))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    base = tlayers.apply_rope(torch.tensor(x), torch.tensor(text), cfg).numpy()
    assert (np.abs(got - base).max() > 1e-4) == (streams == "h_diverges")


def test_mrope_positions_and_decode_broadcast():
    """``_positions`` gives M-RoPE its (3, B, S) text streams, each the token
    index; a decode token's position is the same on all three streams, so
    ``_new_kv`` equals the reference's."""
    jcfg = jget_config("qwen2_vl_7b").reduced()
    cfg = _port_cfg(jcfg)
    pos = transformer._positions(cfg, 2, 5, torch.device("cpu"))
    assert tuple(pos.shape) == (3, 2, 5) and pos.dtype == torch.int32
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jtransformer._positions(jcfg, 2, 5)))
    jp = jlayers.init_params(jax.random.PRNGKey(4), jlayers.attention_defs(jcfg))
    p = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jp)
    x = np.random.default_rng(9).standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    got = tlayers._new_kv(p, torch.tensor(x), cfg, 7)
    want = jlayers._new_kv(jp, jnp.asarray(x), jcfg, jnp.int32(7))
    for g, w in zip(got, want):
        _close(g, np.asarray(w))


def test_attn_probs_bf16_matches_reference():
    """``attn_probs_bf16``: f32 max/sum statistics, bf16 softmax weights.
    Against the reference run op by op, the same bf16 roundings: 1e-5 of max
    |logit|. Compiled (its layer scan), XLA keeps the weights in f32 inside
    the fusion, which moves the logits by up to a bf16 rounding of the
    weights: 2^-8 of max |logit| against that run."""
    jcfg = dataclasses.replace(jget_config("granite_8b").reduced(), attn_probs_bf16=True)
    jmod = jget_module(jcfg)
    jparams = jmod.init(jax.random.PRNGKey(0), jcfg)
    toks = _tokens(jcfg)
    with jax.disable_jit():
        eager = np.asarray(jmod.forward(jparams, jnp.asarray(toks), jcfg))
    compiled = np.asarray(jmod.forward(jparams, jnp.asarray(toks), jcfg))
    cfg = _port_cfg(jcfg)
    params = convert.model_params(_np_tree(jparams), cfg, device="cpu")
    got = transformer.forward(params, torch.tensor(toks), cfg)
    _close(got, eager)
    _close(got, compiled, rel=2.0 ** -8)


def test_init_params_takes_the_card_unless_asked_for_the_cpu():
    """``init_params`` defaults to the card like every entry point of the
    port: without one it raises, and ``device="cpu"`` puts the tree on the
    host."""
    defs = {"norm": tlayers.rmsnorm_defs(8)}
    assert tlayers.init_params(None, defs, device="cpu")["norm"]["w"].device.type == "cpu"
    if torch.cuda.is_available():
        assert tlayers.init_params(None, defs)["norm"]["w"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlayers.init_params(None, defs)
