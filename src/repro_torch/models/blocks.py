"""Decoder blocks: the repeating group pattern of the dense and MoE families.

A *group* is the repeating unit of layers (one layer for plain archs, the
(local, global) pair for gemma2). Each layer in a group is described by a
layout descriptor and owns norms + attention + an MLP or a mixture of
experts. The model keeps one param dict (and one cache dict) per group, in
a list, where the reference stacks them along a leading axis for its layer
scan.

Ported: ``LayerDesc``, ``group_layout`` (dense, ``alt_local_global`` and
MoE), ``group_defs``, ``group_cache_defs``, ``_residual``, ``group_fwd``,
``group_decode_tokens``, ``apply_decode_deltas``. Still to come from the
reference module: SSM layers (the ``ssm`` and ``hybrid`` families raise, as
does ``encdec``, ROADMAP Queue A item 7) and ``group_decode`` (the
write-through decode the encoder-decoder family uses).
"""
from __future__ import annotations

import dataclasses

import torch

from .config import ArchConfig
from .layers import (
    _new_kv,
    attention_cache_defs,
    attention_decode_append,
    attention_defs,
    attention_fwd,
    mlp_defs,
    mlp_fwd,
    rmsnorm,
    rmsnorm_defs,
)
from .moe import moe_defs, moe_fwd

_WAITS = "ROADMAP Queue A item 7"


@dataclasses.dataclass(frozen=True)
class LayerDesc:
    mixer: str          # "attn" (the reference also has "ssm")
    local: bool = False
    mlp: str | None = "dense"  # "dense" | "moe" (the reference also has None)


def group_layout(cfg: ArchConfig) -> list[LayerDesc]:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet: SSM layers, the "
            f"hybrid and encoder-decoder families wait for {_WAITS}")
    if cfg.alt_local_global:
        return [LayerDesc(mixer="attn", local=True), LayerDesc(mixer="attn", local=False)]
    return [LayerDesc(mixer="attn", mlp="moe" if cfg.num_experts else "dense")]


def group_defs(cfg: ArchConfig):
    out = {}
    for i, desc in enumerate(group_layout(cfg)):
        layer = {
            "pre_norm": rmsnorm_defs(cfg.d_model),
            "mixer": attention_defs(cfg),
            "mlp_norm": rmsnorm_defs(cfg.d_model),
            "mlp": moe_defs(cfg) if desc.mlp == "moe" else mlp_defs(cfg),
        }
        if cfg.post_block_norms:
            layer["post_norm"] = rmsnorm_defs(cfg.d_model)
            layer["post_mlp_norm"] = rmsnorm_defs(cfg.d_model)
        out[f"layer{i}"] = layer
    return out


def group_cache_defs(cfg: ArchConfig, batch: int, seq: int):
    return {f"layer{i}": attention_cache_defs(cfg, batch, seq)
            for i, _ in enumerate(group_layout(cfg))}


def _residual(cfg, p, x, branch, post_key):
    if cfg.post_block_norms and post_key in p:
        branch = rmsnorm(p[post_key], branch, cfg.norm_eps)
    return x + branch


def _mlp_block(cfg, desc, p, x):
    h = rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
    y = moe_fwd(p["mlp"], h, cfg) if desc.mlp == "moe" else mlp_fwd(p["mlp"], h, cfg)
    return _residual(cfg, p, x, y, "post_mlp_norm")


def group_fwd(p_group, x, cfg: ArchConfig, pos, collect_cache: bool = False):
    """Full-sequence forward through one group. Returns (x, cache|None)."""
    caches = {}
    for i, desc in enumerate(group_layout(cfg)):
        p = p_group[f"layer{i}"]
        h = rmsnorm(p["pre_norm"], x, cfg.norm_eps)
        y, (k, v) = attention_fwd(p["mixer"], h, cfg, pos, layer_local=desc.local)
        if collect_cache:
            caches[f"layer{i}"] = {"k": k, "v": v}
        x = _residual(cfg, p, x, y, "post_norm")
        x = _mlp_block(cfg, desc, p, x)
    return x, (caches if collect_cache else None)


def group_decode_tokens(p_group, x, cfg: ArchConfig, cache_group, cache_pos):
    """One-token decode that treats the cache as READ-ONLY and emits only the
    per-layer deltas: the new token's (kn, vn) in the cache's dtype. The
    caller writes them back (:func:`apply_decode_deltas`)."""
    deltas = {}
    for i, desc in enumerate(group_layout(cfg)):
        p = p_group[f"layer{i}"]
        cache = cache_group[f"layer{i}"]
        h = rmsnorm(p["pre_norm"], x, cfg.norm_eps)
        kn, vn, q = _new_kv(p["mixer"], h, cfg, cache_pos)
        y = attention_decode_append(
            p["mixer"], h, cfg, cache["k"], cache["v"], cache_pos,
            layer_local=desc.local, precomputed=(kn, vn, q),
        )
        deltas[f"layer{i}"] = {
            "k": kn.to(cache["k"].dtype),
            "v": vn.to(cache["v"].dtype),
        }
        x = _residual(cfg, p, x, y, "post_norm")
        x = _mlp_block(cfg, desc, p, x)
    return x, deltas


def apply_decode_deltas(cache, deltas, cfg: ArchConfig, cache_pos):
    """Write the per-group, per-layer one-token deltas into the cache, IN
    PLACE (the reference returns a new cache; the port saves the copy), and
    return it. ``cache``/``deltas`` are lists over groups. A scalar
    ``cache_pos`` writes every row at one position; a ``(B,)`` one writes
    row ``b`` at ``cache_pos[b]`` (continuous batching)."""
    per_row = isinstance(cache_pos, torch.Tensor) and cache_pos.ndim > 0
    if not per_row:
        p0 = int(cache_pos)
    for cache_g, delta_g in zip(cache, deltas):
        for i, _ in enumerate(group_layout(cfg)):
            key = f"layer{i}"
            for name in ("k", "v"):
                leaf, delta = cache_g[key][name], delta_g[key][name]
                if per_row:
                    rows = torch.arange(leaf.shape[0], device=leaf.device)
                    leaf[rows, cache_pos.to(leaf.device).long()] = delta[:, 0]
                else:
                    leaf[:, p0:p0 + 1] = delta
    return cache
