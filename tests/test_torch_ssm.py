"""The port's Mamba-2 SSD block (``repro_torch.models.ssm``) and the SSM and
hybrid families held against the JAX reference on the CPU.

The same numpy-seeded inputs go through both packages; block params are the
reference's own (``init_params(PRNGKey)``), carried over as tensors.
Tolerances, each with its reason:

* ``ssd_chunked`` / ``ssm_fwd`` / ``ssm_decode`` against the reference:
  within 1e-5 of each output's max (f32 contractions, the port's two-operand
  products summed in another order than XLA's four-operand einsums);
* against the naive recurrence and decode against the chunked forward: the
  reference test's own 1e-3 / 5e-3 (two algorithms, f32);
* a served step against ``forward``: the decode-vs-forward 2e-2 of
  ``tests/test_models.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import blocks as jblocks
from repro.models import ssm as jssm
from repro.models.config import ArchConfig as JArchConfig
from repro.models.layers import init_params as jinit_params
from repro.models.registry import get_config as jget_config
from repro_torch.models import blocks, ssm, transformer
from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import get_config


def _port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**dataclasses.asdict(jcfg))


def _t(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _close(got, want, rel=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * top, (err, top)


def _ssd_inputs(s, seed, bsz=2, h=3, p=4, n=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, h)))).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    b = rng.standard_normal((bsz, s, n)).astype(np.float32)
    c = rng.standard_normal((bsz, s, n)).astype(np.float32)
    return x, dt, a, b, c


def naive_ssd(x, dt, a, b, c):
    """Direct recurrence h_t = exp(dt a) h + dt B x ; y = C h (the reference
    test's ``naive_ssd``, in PyTorch)."""
    bsz, s, h, p = x.shape
    state = torch.zeros((bsz, h, p, b.shape[-1]))
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a)
        state = state * decay[:, :, None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], x[:, t], b[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", state, c[:, t]))
    return torch.stack(ys, dim=1), state


# (16, 4), (24, 8), (8, 8): the reference test's shapes; (13, 4) leaves a
# tail of 1 that the scan pads with dt = 0
SSD_SHAPES = [(16, 4), (24, 8), (8, 8), (13, 4)]


@pytest.mark.parametrize("s,chunk", SSD_SHAPES)
def test_ssd_chunked_matches_reference(s, chunk):
    arrays = _ssd_inputs(s, seed=s + chunk)
    y, final = ssm.ssd_chunked(*map(torch.tensor, arrays), chunk)
    jy, jfinal = jssm.ssd_chunked(*map(jnp.asarray, arrays), chunk)
    assert y.dtype == torch.float32 and tuple(y.shape) == (2, s, 3, 4)
    _close(y, jy)
    _close(final, jfinal)


@pytest.mark.parametrize("s,chunk", SSD_SHAPES)
def test_ssd_chunked_matches_naive(s, chunk):
    arrays = [torch.tensor(a) for a in _ssd_inputs(s, seed=100 + s)]
    y_c, st_c = ssm.ssd_chunked(*arrays, chunk)
    y_n, st_n = naive_ssd(*arrays)
    torch.testing.assert_close(y_c, y_n, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(st_c, st_n, rtol=1e-3, atol=1e-3)


def test_segsum_masks_with_minus_inf():
    """Above the diagonal the segment sums are -inf, exactly 0 after exp;
    below, the reference's within 1e-6 (its cumsum adds in another order)."""
    x = torch.tensor(np.random.default_rng(3).standard_normal((2, 5)).astype(np.float32))
    out = ssm._segsum(x)
    above = torch.ones(5, 5, dtype=torch.bool).triu(1)
    assert bool(torch.isneginf(out[:, above]).all())
    assert bool((torch.exp(out)[:, above] == 0).all())
    np.testing.assert_allclose(out.numpy(), np.asarray(jssm._segsum(jnp.asarray(x.numpy()))),
                               rtol=1e-6, atol=1e-6)


def _tiny_jcfg():
    return JArchConfig(name="ssm-test", family="ssm", d_model=32, d_inner=64,
                       ssm_state=8, ssm_headdim=16, ssm_chunk=4, dtype="float32")


@pytest.fixture(scope="module")
def block():
    jcfg = _tiny_jcfg()
    jp = jinit_params(jax.random.PRNGKey(0), jssm.ssm_defs(jcfg))
    x = np.random.default_rng(4).standard_normal((2, 10, jcfg.d_model)).astype(np.float32)
    return jcfg, jp, _port_cfg(jcfg), _t(jp), x


def test_ssm_fwd_matches_reference(block):
    jcfg, jp, cfg, p, x = block
    y, cache = ssm.ssm_fwd(p, torch.tensor(x), cfg)
    jy, jcache = jssm.ssm_fwd(jp, jnp.asarray(x), jcfg)
    _close(y, jy)
    assert set(cache) == {"state", "conv"} and cache["state"].dtype == torch.float32
    _close(cache["state"], jcache["state"])
    _close(cache["conv"], jcache["conv"])
    assert tuple(cache["conv"].shape) == (2, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)


def test_ssm_decode_matches_reference(block):
    """Three recurrent steps from the reference's own prefill cache."""
    jcfg, jp, cfg, p, x = block
    _, jcache = jssm.ssm_fwd(jp, jnp.asarray(x[:, :7]), jcfg)
    cache = _t(jcache)
    for t in range(7, 10):
        y, cache = ssm.ssm_decode(p, torch.tensor(x[:, t:t + 1]), cfg, cache)
        jy, jcache = jssm.ssm_decode(jp, jnp.asarray(x[:, t:t + 1]), jcfg, jcache)
        _close(y, jy)
        _close(cache["state"], jcache["state"])
        _close(cache["conv"], jcache["conv"])
    assert cache["state"].dtype == torch.float32


def test_ssm_block_decode_matches_fwd(block):
    """The last token replayed through the decode path from the cache of the
    first seven equals the full forward's (the reference's test, port-only)."""
    _, _, cfg, p, x = block
    xt = torch.tensor(x[:, :8])
    y_full, _ = ssm.ssm_fwd(p, xt, cfg)
    _, cache7 = ssm.ssm_fwd(p, xt[:, :7], cfg)
    y_dec, _ = ssm.ssm_decode(p, xt[:, 7:8], cfg, cache7)
    torch.testing.assert_close(y_dec[:, 0], y_full[:, 7], rtol=5e-3, atol=5e-3)


def test_ssm_state_continuity(block):
    """fwd(x) final state == fwd(x1) + decode steps over x2's states."""
    _, _, cfg, p, x = block
    xt = torch.tensor(x)
    _, cache_full = ssm.ssm_fwd(p, xt, cfg)
    _, cache = ssm.ssm_fwd(p, xt[:, :6], cfg)
    for t in range(6, 10):
        _, cache = ssm.ssm_decode(p, xt[:, t:t + 1], cfg, cache)
    torch.testing.assert_close(cache["state"], cache_full["state"], rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("arch", ["mamba2_370m", "jamba_1p5_large"])
def test_group_layout_is_the_reference_layout(arch):
    """mamba2: one SSM layer without an MLP. jamba (the hybrid pattern):
    attention at ``period // 2`` of 8, MoE where ``i % moe_every ==
    moe_every - 1``, dense MLPs elsewhere; the defs and cache defs carry the
    same leaves as the reference's."""
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    got = [(d.mixer, d.local, d.mlp) for d in blocks.group_layout(cfg)]
    want = [(d.mixer, d.local, d.mlp) for d in jblocks.group_layout(jcfg)]
    assert got == want
    if arch == "jamba_1p5_large":
        assert [m for m, _, _ in got].count("attn") == 1 and got[4][0] == "attn"
        assert [mlp for _, _, mlp in got] == ["dense", "moe"] * 4
    else:
        assert got == [("ssm", False, None)]

    def shapes(defs):
        if "shape" in defs and "axes" in defs:
            return defs["shape"]
        return {k: shapes(v) for k, v in defs.items()}

    assert shapes(blocks.group_defs(cfg)) == shapes(jblocks.group_defs(jcfg))
    assert shapes(blocks.group_cache_defs(cfg, 2, 9)) == \
        shapes(jblocks.group_cache_defs(jcfg, 2, 9))


def test_prefill_at_prompt_length_ssm_heads_decodes():
    """The reference's prefill pads cache leaves by shape: at a prompt length
    equal to ``ssm_heads`` (4 at ``mamba2_370m.reduced()``) it pads an SSM
    state's heads axis too, and its next decode step fails. The port pads
    attention k/v by key, so the state keeps its shape and the step matches
    the port's own ``forward`` (the reference cannot be the yardstick here;
    the parity tests compare at a prompt length of 12)."""
    cfg = get_config("mamba2_370m").reduced()
    s = cfg.ssm_heads
    assert s == 4
    params = transformer.init(0, cfg, device="cpu")
    toks = torch.tensor(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, s + 2)))
    full = transformer.forward(params, toks, cfg)
    logits, cache = transformer.prefill(params, toks[:, :s], cfg, cache_len=s + 4)
    state = cache[0]["layer0"]["state"]
    assert tuple(state.shape) == (2, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
    assert state.dtype == torch.float32
    torch.testing.assert_close(logits, full[:, s - 1], rtol=2e-2, atol=2e-2)
    for i in range(2):
        step, cache = transformer.decode_step(params, cache, toks[:, s + i], s + i, cfg)
        torch.testing.assert_close(step, full[:, s + i], rtol=2e-2, atol=2e-2)
    assert tuple(cache[0]["layer0"]["state"].shape) == tuple(state.shape)


def test_hybrid_cache_keeps_its_dtypes():
    """A bf16 jamba decoding from ``init_cache`` (every leaf bf16): the
    attention layer's k/v are written in place, the SSM layers' state (f32
    out of the step) and conv replaced by the step's, cast to the cache's
    dtypes (the reference's ``group_decode_tokens`` casts)."""
    cfg = dataclasses.replace(get_config("jamba_1p5_large").reduced(), dtype="bfloat16")
    params = transformer.init(0, cfg, device="cpu")
    cache = transformer.init_cache(cfg, 2, 6, device="cpu")
    k_before = cache[0]["layer4"]["k"]
    tok = torch.tensor([3, 7])
    logits, cache = transformer.decode_step(params, cache, tok, 0, cfg)
    assert bool(torch.isfinite(logits).all())
    assert cache[0]["layer4"]["k"] is k_before and float(k_before[:, 0].abs().max()) > 0
    for key in ("layer0", "layer7"):
        assert cache[0][key]["state"].dtype == torch.bfloat16
        assert cache[0][key]["conv"].dtype == torch.bfloat16
        assert float(cache[0][key]["state"].abs().max()) > 0
