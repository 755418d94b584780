"""Decoder blocks: the repeating group pattern for every family.

A *group* is the repeating unit of layers (one layer for plain archs, the
(local, global) pair for gemma2, the 1-attn+7-mamba octet for jamba). Each
layer in a group is described by a layout descriptor and owns norms + mixer
(attention or SSD) + an optional MLP or mixture of experts. The model keeps
one param dict (and one cache dict) per group, in a list, where the
reference stacks them along a leading axis for its layer scan.

Port of the reference module: ``LayerDesc``, ``group_layout`` (dense,
``alt_local_global``, MoE, SSM and the hybrid ``hybrid_attn_period`` /
``moe_every`` pattern), ``group_defs``, ``group_cache_defs``,
``_residual``, ``group_fwd``, ``group_decode`` (the write-through decode:
the cache written in place, then read), ``group_decode_tokens`` and
``apply_decode_deltas`` (the read-only decode the models step through,
then the write-back).
"""
from __future__ import annotations

import dataclasses

import torch

from .config import ArchConfig
from .layers import (
    _new_kv,
    attention_cache_defs,
    attention_decode,
    attention_decode_append,
    attention_defs,
    attention_fwd,
    mlp_defs,
    mlp_fwd,
    rmsnorm,
    rmsnorm_defs,
)
from .moe import moe_defs, moe_fwd
from .ssm import ssm_cache_defs, ssm_decode, ssm_defs, ssm_fwd


@dataclasses.dataclass(frozen=True)
class LayerDesc:
    mixer: str          # "attn" | "ssm"
    local: bool = False
    mlp: str | None = "dense"  # "dense" | "moe" | None


def group_layout(cfg: ArchConfig) -> list[LayerDesc]:
    if cfg.family == "ssm":
        return [LayerDesc(mixer="ssm", mlp=None)]
    if cfg.family == "hybrid" and cfg.hybrid_attn_period:
        period = cfg.hybrid_attn_period
        out = []
        for i in range(period):
            mixer = "attn" if i == period // 2 else "ssm"
            mlp = "moe" if (cfg.num_experts and i % cfg.moe_every == cfg.moe_every - 1) else "dense"
            out.append(LayerDesc(mixer=mixer, mlp=mlp))
        return out
    if cfg.alt_local_global:
        return [LayerDesc(mixer="attn", local=True), LayerDesc(mixer="attn", local=False)]
    return [LayerDesc(mixer="attn", mlp="moe" if cfg.num_experts else "dense")]


def group_defs(cfg: ArchConfig):
    out = {}
    for i, desc in enumerate(group_layout(cfg)):
        layer = {
            "pre_norm": rmsnorm_defs(cfg.d_model),
            "mixer": attention_defs(cfg) if desc.mixer == "attn" else ssm_defs(cfg),
        }
        if desc.mlp is not None:
            layer["mlp_norm"] = rmsnorm_defs(cfg.d_model)
            layer["mlp"] = moe_defs(cfg) if desc.mlp == "moe" else mlp_defs(cfg)
        if cfg.post_block_norms:
            layer["post_norm"] = rmsnorm_defs(cfg.d_model)
            if desc.mlp is not None:
                layer["post_mlp_norm"] = rmsnorm_defs(cfg.d_model)
        out[f"layer{i}"] = layer
    return out


def group_cache_defs(cfg: ArchConfig, batch: int, seq: int):
    return {f"layer{i}": (attention_cache_defs(cfg, batch, seq) if desc.mixer == "attn"
                          else ssm_cache_defs(cfg, batch))
            for i, desc in enumerate(group_layout(cfg))}


def _residual(cfg, p, x, branch, post_key):
    if cfg.post_block_norms and post_key in p:
        branch = rmsnorm(p[post_key], branch, cfg.norm_eps)
    return x + branch


def _mlp_block(cfg, desc, p, x):
    if desc.mlp is None:
        return x
    h = rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
    y = moe_fwd(p["mlp"], h, cfg) if desc.mlp == "moe" else mlp_fwd(p["mlp"], h, cfg)
    return _residual(cfg, p, x, y, "post_mlp_norm")


def group_fwd(p_group, x, cfg: ArchConfig, pos, collect_cache: bool = False):
    """Full-sequence forward through one group. Returns (x, cache|None)."""
    caches = {}
    for i, desc in enumerate(group_layout(cfg)):
        p = p_group[f"layer{i}"]
        h = rmsnorm(p["pre_norm"], x, cfg.norm_eps)
        if desc.mixer == "attn":
            y, (k, v) = attention_fwd(p["mixer"], h, cfg, pos, layer_local=desc.local)
            layer_cache = {"k": k, "v": v}
        else:
            y, layer_cache = ssm_fwd(p["mixer"], h, cfg)
        if collect_cache:
            caches[f"layer{i}"] = layer_cache
        x = _residual(cfg, p, x, y, "post_norm")
        x = _mlp_block(cfg, desc, p, x)
    return x, (caches if collect_cache else None)


def group_decode(p_group, x, cfg: ArchConfig, cache_group, cache_pos):
    """One-token decode through one group. Returns (x, new_cache_group):
    attention layers write the token's k/v into their cache IN PLACE at the
    scalar ``cache_pos`` and attend over it (:func:`attention_decode`; the
    reference returns updated copies), SSM layers return their new
    (state, conv)."""
    new_caches = {}
    for i, desc in enumerate(group_layout(cfg)):
        p = p_group[f"layer{i}"]
        cache = cache_group[f"layer{i}"]
        h = rmsnorm(p["pre_norm"], x, cfg.norm_eps)
        if desc.mixer == "attn":
            y, nc = attention_decode(p["mixer"], h, cfg, cache, cache_pos, layer_local=desc.local)
        else:
            y, nc = ssm_decode(p["mixer"], h, cfg, cache)
        new_caches[f"layer{i}"] = nc
        x = _residual(cfg, p, x, y, "post_norm")
        x = _mlp_block(cfg, desc, p, x)
    return x, new_caches


def group_decode_tokens(p_group, x, cfg: ArchConfig, cache_group, cache_pos):
    """One-token decode that treats the cache as READ-ONLY and emits only the
    per-layer deltas, in the cache's dtypes: the new token's (kn, vn) for
    attention layers, the new (state, conv) for SSM layers. The caller
    writes them back (:func:`apply_decode_deltas`)."""
    deltas = {}
    for i, desc in enumerate(group_layout(cfg)):
        p = p_group[f"layer{i}"]
        cache = cache_group[f"layer{i}"]
        h = rmsnorm(p["pre_norm"], x, cfg.norm_eps)
        if desc.mixer == "attn":
            kn, vn, q = _new_kv(p["mixer"], h, cfg, cache_pos)
            y = attention_decode_append(
                p["mixer"], h, cfg, cache["k"], cache["v"], cache_pos,
                layer_local=desc.local, precomputed=(kn, vn, q),
            )
            deltas[f"layer{i}"] = {
                "k": kn.to(cache["k"].dtype),
                "v": vn.to(cache["v"].dtype),
            }
        else:
            y, nc = ssm_decode(p["mixer"], h, cfg, cache)
            deltas[f"layer{i}"] = {name: t.to(cache[name].dtype) for name, t in nc.items()}
        x = _residual(cfg, p, x, y, "post_norm")
        x = _mlp_block(cfg, desc, p, x)
    return x, deltas


def apply_decode_deltas(cache, deltas, cfg: ArchConfig, cache_pos):
    """Write the per-group, per-layer one-token deltas into the cache, IN
    PLACE (the reference returns a new cache; the port saves the copy), and
    return it. ``cache``/``deltas`` are lists over groups. Attention k/v: a
    scalar ``cache_pos`` writes every row at one position; a ``(B,)`` one
    writes row ``b`` at ``cache_pos[b]`` (continuous batching). SSM
    state/conv: replaced whole (states are step-sized anyway)."""
    per_row = isinstance(cache_pos, torch.Tensor) and cache_pos.ndim > 0
    if not per_row:
        p0 = int(cache_pos)
    for cache_g, delta_g in zip(cache, deltas):
        for i, desc in enumerate(group_layout(cfg)):
            key = f"layer{i}"
            if desc.mixer != "attn":
                cache_g[key] = delta_g[key]
                continue
            for name in ("k", "v"):
                leaf, delta = cache_g[key][name], delta_g[key][name]
                if type(leaf) is not torch.Tensor:
                    from repro_torch.dist.placement import is_dtensor, write_position
                    if is_dtensor(leaf):
                        if per_row:
                            raise NotImplementedError("per-row decode positions on a model "
                                                      "mesh (the paged loop is one card)")
                        write_position(leaf, delta, p0)
                        continue
                if per_row:
                    rows = torch.arange(leaf.shape[0], device=leaf.device)
                    leaf[rows, cache_pos.to(leaf.device).long()] = delta[:, 0]
                else:
                    leaf[:, p0:p0 + 1] = delta
    return cache
