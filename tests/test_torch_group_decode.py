"""The write-through decode of the port held against the JAX reference on
the CPU: ``blocks.group_decode`` and ``layers.attention_decode``'s
``precomputed_q`` / ``skip_kv_write`` options.

Reduced (f32) granite-8b (dense), gemma2-27b (a local layer with its
sliding window of 8 and the logit softcap beside a global one) and
jamba-1.5-large (seven SSM layers and one attention layer, MoE MLPs). The
reference's own params (``init(PRNGKey(0))``) and its prefill cache of a
numpy-seeded prompt go through both packages (``convert``); the token's
hidden state is numpy-seeded. Tolerance, that of the port's decode tests
(``test_torch_models.py``): outputs within 1e-5 of max |out|, caches within
1e-5 of each leaf's max (f32 matmuls, sums in another order).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models.registry import get_config as jget_config
from repro.models.registry import get_module as jget_module
from repro_torch import convert
from repro_torch.models import blocks as tblocks
from repro_torch.models import layers as tlayers
from repro_torch.models.config import ArchConfig

ARCHS = ("granite_8b", "gemma2_27b", "jamba_1p5_large")
B, PROMPT, CACHE = 2, 12, 16


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """The reference's config, params and prefill cache, and group 0 of
    each, as numpy trees; the token's hidden state."""
    jcfg = jget_config(arch).reduced()
    mod = jget_module(jcfg)
    params = mod.init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (B, PROMPT), dtype=np.int32)
    _, cache = mod.prefill(params, jnp.asarray(toks), jcfg, cache_len=CACHE)
    group0 = lambda tree: jax.tree.map(lambda a: np.asarray(a[0]), tree)
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    return jcfg, jax.tree.map(np.asarray, params), group0(params["blocks"]), group0(cache), x


def _port(arch):
    jcfg, params, _, cache, x = _setup(arch)
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    tparams = convert.model_params(params, cfg, device="cpu")
    tcache = convert.model_cache(jax.tree.map(lambda a: a[None], cache), device="cpu")[0]
    return cfg, tparams["blocks"][0], tcache, torch.tensor(x)


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    top = float(np.abs(want).max())
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= rel * top, (err, top)


@pytest.mark.parametrize("arch", ARCHS)
def test_group_decode_matches_reference(arch):
    """One token through group 0 at cache position PROMPT: the hidden state
    and every layer's new cache; the port writes its attention caches in
    place (the same tensors come back), the reference returns copies."""
    jcfg, _, jgroup, jcache, x = _setup(arch)
    want_x, want_cache = jblocks.group_decode(
        jax.tree.map(jnp.asarray, jgroup), jnp.asarray(x), jcfg,
        jax.tree.map(jnp.asarray, jcache), jnp.int32(PROMPT))
    cfg, group, cache, tx = _port(arch)
    before = {key: dict(layer) for key, layer in cache.items()}
    got_x, got_cache = tblocks.group_decode(group, tx, cfg, cache, PROMPT)
    _close(got_x, want_x)
    assert set(got_cache) == set(want_cache)
    for key, layer in want_cache.items():
        assert set(got_cache[key]) == set(layer)
        for name, leaf in layer.items():
            assert tuple(got_cache[key][name].shape) == leaf.shape
            _close(got_cache[key][name], leaf)
            if "k" in layer:
                assert got_cache[key][name] is before[key][name]


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_decode_options_match_reference(arch):
    """Each attention layer of group 0: the token's q/k/v projected once
    (``_new_kv``), written into the cache by the caller, then
    ``attention_decode(precomputed_q=q, skip_kv_write=True)`` and
    ``attention_decode(skip_kv_write=True)`` (q projected inside) against the
    reference's, and both equal to the plain write-through call; the cache
    is left as the caller wrote it. ``precomputed_q`` without
    ``skip_kv_write`` has no k/v to write and raises."""
    jcfg, _, jgroup, jcache, x = _setup(arch)
    cfg, group, cache, tx = _port(arch)
    descs = [(i, d) for i, d in enumerate(tblocks.group_layout(cfg)) if d.mixer == "attn"]
    assert descs
    for i, desc in descs:
        key = f"layer{i}"
        jp = jax.tree.map(jnp.asarray, jgroup[key]["mixer"])
        jc = jax.tree.map(jnp.asarray, jcache[key])
        kn, vn, q = jlayers._new_kv(jp, jnp.asarray(x), jcfg, jnp.int32(PROMPT))
        jc = {name: jax.lax.dynamic_update_slice(jc[name], t.astype(jc[name].dtype),
                                                 (0, PROMPT, 0, 0))
              for name, t in (("k", kn), ("v", vn))}
        want, _ = jlayers.attention_decode(jp, jnp.asarray(x), jcfg, jc, jnp.int32(PROMPT),
                                           layer_local=desc.local, precomputed_q=q,
                                           skip_kv_write=True)
        want_skip, _ = jlayers.attention_decode(jp, jnp.asarray(x), jcfg, jc,
                                                jnp.int32(PROMPT), layer_local=desc.local,
                                                skip_kv_write=True)

        p = group[key]["mixer"]
        c = {name: t.clone() for name, t in cache[key].items()}
        tkn, tvn, tq = tlayers._new_kv(p, tx, cfg, PROMPT)
        c["k"][:, PROMPT:PROMPT + 1] = tkn
        c["v"][:, PROMPT:PROMPT + 1] = tvn
        written = {name: t.clone() for name, t in c.items()}
        got, out = tlayers.attention_decode(p, tx, cfg, c, PROMPT, layer_local=desc.local,
                                            precomputed_q=tq, skip_kv_write=True)
        _close(got, want)
        assert out is c and all(torch.equal(c[n], written[n]) for n in c)
        got_skip, _ = tlayers.attention_decode(p, tx, cfg, c, PROMPT, layer_local=desc.local,
                                               skip_kv_write=True)
        _close(got_skip, want_skip)
        assert all(torch.equal(c[n], written[n]) for n in c)
        fresh = {name: t.clone() for name, t in cache[key].items()}
        plain, _ = tlayers.attention_decode(p, tx, cfg, fresh, PROMPT, layer_local=desc.local)
        assert torch.equal(plain, got) and torch.equal(plain, got_skip)
        assert all(torch.equal(fresh[n], written[n]) for n in c)
        with pytest.raises(ValueError, match="skip_kv_write"):
            tlayers.attention_decode(p, tx, cfg, fresh, PROMPT, precomputed_q=tq)
