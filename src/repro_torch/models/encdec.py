"""Encoder-decoder transformer (seamless-m4t backbone).

The audio frontend is a STUB: the encoder consumes precomputed frame
embeddings (B, S, d_model). The decoder is a standard causal transformer
with cross-attention into the encoder output; serve-side, the cross KV is
computed once at prefill and the decoder self-attention keeps a growing KV
cache, written in place a token at a time.

The reference scans stacked ``(L, ...)`` layer params; the port keeps
``params["encoder"]`` and ``params["decoder"]`` as lists of per-layer dicts
and loops over them, and the cache as a list over decoder layers of
``{"self": {"k", "v"}, "cross": {"k", "v"}}``.

Ported: ``param_defs``, ``init``, ``_cross_attention``, ``_cross_kv``,
``encode``, ``_decoder_fwd``, ``_head``, ``forward``, ``prefill``,
``cache_defs``, ``init_cache``, ``decode_step``, ``loss_fn``. ``frame_proj``
and the head are plain matrix products (never pSRAM), as in the reference;
every other projection goes through ``layers._proj``. ``cfg.remat`` has no
effect here, as in the reference (its encoder-decoder scans without
``jax.checkpoint``). ``param_specs`` and ``cache_specs`` give the
logical-axis trees in the port's per-layer layout.
"""
from __future__ import annotations

import torch

from repro_torch.dist.sharding import hint

from .config import ArchConfig
from .layers import (
    NEG_INF,
    _new_kv,
    _proj,
    _sdpa,
    as_dtype,
    attention_cache_defs,
    attention_decode,
    attention_decode_append,
    attention_defs,
    attention_fwd,
    ddef,
    init_params,
    mlp_defs,
    mlp_fwd,
    rmsnorm,
    rmsnorm_defs,
    specs_of,
)
from .transformer import _pad_seq, _positions


def _enc_layer_defs(cfg):
    return {
        "pre_norm": rmsnorm_defs(cfg.d_model),
        "attn": attention_defs(cfg),
        "mlp_norm": rmsnorm_defs(cfg.d_model),
        "mlp": mlp_defs(cfg),
    }


def _dec_layer_defs(cfg):
    return {
        "pre_norm": rmsnorm_defs(cfg.d_model),
        "self_attn": attention_defs(cfg),
        "cross_norm": rmsnorm_defs(cfg.d_model),
        "cross_attn": attention_defs(cfg),
        "mlp_norm": rmsnorm_defs(cfg.d_model),
        "mlp": mlp_defs(cfg),
    }


def param_defs(cfg: ArchConfig):
    return {
        "frame_proj": ddef((cfg.d_model, cfg.d_model), ("embed", "embed")),
        "embed": ddef((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), scale=1.0),
        "encoder": [_enc_layer_defs(cfg) for _ in range(cfg.enc_layers)],
        "enc_norm": rmsnorm_defs(cfg.d_model),
        "decoder": [_dec_layer_defs(cfg) for _ in range(cfg.dec_layers)],
        "final_norm": rmsnorm_defs(cfg.d_model),
        "head": ddef((cfg.d_model, cfg.padded_vocab), ("embed", "vocab")),
    }


def init(seed_or_gen, cfg: ArchConfig, device="cuda"):
    """Random parameters in ``cfg.dtype`` on ``device``, from a seed or a
    ``torch.Generator`` (on ``device``)."""
    return init_params(seed_or_gen, param_defs(cfg), dtype=as_dtype(cfg.dtype), device=device)


def param_specs(cfg: ArchConfig):
    return specs_of(param_defs(cfg))


def _cross_attention(p, x, kv, cfg: ArchConfig):
    """Non-causal, non-rotary attention of decoder states into encoder KV."""
    b, s, _ = x.shape
    q = _proj(x, p["wq"], cfg).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k, v = kv
    bias = torch.zeros((1, k.shape[1]), dtype=torch.float32, device=x.device)
    out = _sdpa(q, k, v, bias, cfg)
    return _proj(out.reshape(b, s, cfg.q_dim), p["wo"], cfg)


def _cross_kv(p, enc_out, cfg: ArchConfig):
    b, s, _ = enc_out.shape
    k = _proj(enc_out, p["wk"], cfg).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = _proj(enc_out, p["wv"], cfg).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    return k, v


def encode(params, frames, cfg: ArchConfig):
    """frames: (B, S, d_model) stub embeddings -> encoder states."""
    b, s, _ = frames.shape
    x = hint(frames @ params["frame_proj"].to(frames.dtype), ("batch", "seq", None))
    pos = _positions(cfg, b, s, x.device)
    for p in params["encoder"]:
        a, _ = attention_fwd(p["attn"], rmsnorm(p["pre_norm"], x, cfg.norm_eps), cfg, pos,
                             causal=False)
        x = x + a
        x = x + mlp_fwd(p["mlp"], rmsnorm(p["mlp_norm"], x, cfg.norm_eps), cfg)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _decoder_fwd(params, tokens, enc_out, cfg: ArchConfig, collect_cache=False):
    b, s = tokens.shape
    x = params["embed"][tokens]
    pos = _positions(cfg, b, s, x.device)
    caches = []
    for p in params["decoder"]:
        a, kv_self = attention_fwd(p["self_attn"], rmsnorm(p["pre_norm"], x, cfg.norm_eps),
                                   cfg, pos)
        x = x + a
        kv_cross = _cross_kv(p["cross_attn"], enc_out, cfg)
        x = x + _cross_attention(p["cross_attn"], rmsnorm(p["cross_norm"], x, cfg.norm_eps),
                                 kv_cross, cfg)
        x = x + mlp_fwd(p["mlp"], rmsnorm(p["mlp_norm"], x, cfg.norm_eps), cfg)
        if collect_cache:
            caches.append({"self": {"k": kv_self[0], "v": kv_self[1]},
                           "cross": {"k": kv_cross[0], "v": kv_cross[1]}})
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, (caches if collect_cache else None)


def _head(params, x, cfg: ArchConfig):
    logits = (x @ params["head"].to(x.dtype)).to(torch.float32)
    if cfg.padded_vocab != cfg.vocab_size:
        iota = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = torch.where(iota < cfg.vocab_size, logits, torch.full_like(logits, NEG_INF))
    return logits


def forward(params, frames, tokens, cfg: ArchConfig):
    """Logits (B, S, V) f32 over the decoder positions."""
    enc_out = encode(params, frames, cfg)
    x, _ = _decoder_fwd(params, tokens, enc_out, cfg)
    return _head(params, x, cfg)


def loss_fn(params, frames, tokens, labels, cfg: ArchConfig):
    """Cross-entropy of the decoder's next-token logits (negative labels are
    padding), ``transformer.cross_entropy``."""
    from .transformer import cross_entropy
    return cross_entropy(forward(params, frames, tokens, cfg), labels)


def prefill(params, frames, tokens, cfg: ArchConfig, cache_len: int):
    """Encode + run the decoder prompt, returning (last logits (B, V), cache):
    the self k/v zero-padded to ``cache_len``, the cross k/v the encoder's."""
    s = tokens.shape[1]
    if cache_len < s:
        raise ValueError(f"cache_len {cache_len} < prompt length {s}")
    enc_out = encode(params, frames, cfg)
    x, caches = _decoder_fwd(params, tokens, enc_out, cfg, collect_cache=True)
    for c in caches:
        c["self"] = {name: _pad_seq(t, cache_len) for name, t in c["self"].items()}
    return _head(params, x[:, -1], cfg), caches


def cache_defs(cfg: ArchConfig, batch: int, dec_len: int, enc_len: int):
    return [{"self": attention_cache_defs(cfg, batch, dec_len),
             "cross": attention_cache_defs(cfg, batch, enc_len)}
            for _ in range(cfg.dec_layers)]


def cache_specs(cfg: ArchConfig, batch: int, dec_len: int, enc_len: int):
    return specs_of(cache_defs(cfg, batch, dec_len, enc_len))


def init_cache(cfg: ArchConfig, batch: int, dec_len: int, enc_len: int, dtype=None,
               device="cuda"):
    """An all-zero cache, a list over decoder layers of ``{"self", "cross"}``."""
    return init_params(None, cache_defs(cfg, batch, dec_len, enc_len),
                       dtype=as_dtype(dtype or cfg.dtype), device=device)


def decode_step(params, cache, token, cache_pos, cfg: ArchConfig):
    """One decoder token against the self cache + the static cross cache.
    token: (B,) int; cache_pos: an int, the tokens already in the self cache.

    Same delta-decode design as the decoder-only path: every layer reads its
    self cache as it stands (the new token enters through the two-block
    softmax combine), and the new token's k/v are written IN PLACE at
    ``cache_pos`` after the last layer; the cross KV is never touched.
    Returns (logits (B, V), cache)."""
    x = params["embed"][token[:, None]]
    deltas = []
    for p, c in zip(params["decoder"], cache):
        hn = rmsnorm(p["pre_norm"], x, cfg.norm_eps)
        kn, vn, q = _new_kv(p["self_attn"], hn, cfg, cache_pos)
        x = x + attention_decode_append(p["self_attn"], hn, cfg, c["self"]["k"],
                                        c["self"]["v"], cache_pos, precomputed=(kn, vn, q))
        cr, _ = attention_decode(p["cross_attn"], rmsnorm(p["cross_norm"], x, cfg.norm_eps),
                                 cfg, c["cross"], cache_pos, cross=True)
        x = x + cr
        x = x + mlp_fwd(p["mlp"], rmsnorm(p["mlp_norm"], x, cfg.norm_eps), cfg)
        deltas.append((kn, vn))
    p0 = int(cache_pos)
    for c, (kn, vn) in zip(cache, deltas):
        c["self"]["k"][:, p0:p0 + 1] = kn.to(c["self"]["k"].dtype)
        c["self"]["v"][:, p0:p0 + 1] = vn.to(c["self"]["v"].dtype)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _head(params, x[:, 0], cfg), cache
