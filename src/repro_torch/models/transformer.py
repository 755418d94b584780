"""Decoder-only LM assembled from block groups.

Covers the families dense, moe, hybrid (jamba) and ssm (mamba2). Provides
``param_defs / init / forward / loss_fn / prefill / decode`` — the train
step in ``train/`` and the serve steps in ``serve/`` wrap these. The
reference scans stacked ``(G, ...)`` group params with ``lax.scan``; the
port keeps one param dict per group in ``params["blocks"]`` (a list) and
loops over it, and likewise one cache dict per group
(``cfg.scan_layers`` therefore has no effect here).

``cfg.remat`` checkpoints each group of ``forward`` while autograd records,
as the reference wraps its scanned body in ``jax.checkpoint``:
``remat_policy="nothing"`` recomputes the whole group in the backward pass
(``nothing_saveable``); ``"dots"`` saves the outputs of the unbatched
matrix products — ``aten.mm`` / ``addmm``, the projections, which is what
``dots_with_no_batch_dims_saveable`` keeps — and recomputes the rest, the
batched attention products (``bmm``) included.

Ported: ``param_defs``, ``init``, ``cache_defs``, ``init_cache``,
``_positions`` (M-RoPE's three streams included), ``_embed``, ``_unembed``,
``forward`` (remat included), ``loss_fn``, ``cross_entropy``, ``prefill``,
``prefill_paged`` (the paged serve loop's), ``decode_step_deltas``,
``decode_step``, ``param_specs`` and ``cache_specs`` (the logical-axis
trees of the params and the cache, in the port's per-group layout).

``prefill`` pads the attention ``k``/``v`` leaves out to ``cache_len``,
chosen by their keys. The reference chooses them by shape (``ndim == 5``
and axis 2 the prompt length), which also pads an SSM ``state`` leaf
``(G, B, H, P, N)`` whenever the prompt length equals ``ssm_heads``, and
its next decode step then fails; the port leaves SSM leaves as they are.

On a model mesh (DTensor parameters, ``dist.placement``) the embedding is a
lookup in each card's vocabulary block, the other rows zero, summed over
the model axis (exact: one card holds each row); the logits stay sharded
over the vocabulary into :func:`cross_entropy`, which takes the max, the
sum of exponentials and the label's logit across the blocks, as the
reference's ``loss_fn`` notes.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                     create_selective_checkpoint_contexts)

import torch.nn.functional as F

from repro_torch._device import as_device
from repro_torch.dist import placement
from repro_torch.dist.sharding import hint

from .blocks import apply_decode_deltas, group_cache_defs, group_decode_tokens, group_defs, group_fwd
from .config import ArchConfig
from .layers import NEG_INF, as_dtype, ddef, init_params, rmsnorm, rmsnorm_defs, specs_of


def param_defs(cfg: ArchConfig):
    defs = {
        "embed": ddef((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), scale=1.0),
        "blocks": [group_defs(cfg) for _ in range(cfg.num_groups)],
        "final_norm": rmsnorm_defs(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        defs["head"] = ddef((cfg.d_model, cfg.padded_vocab), ("embed", "vocab"))
    return defs


def init(seed_or_gen, cfg: ArchConfig, device="cuda"):
    """Random parameters in ``cfg.dtype`` on ``device``, from a seed or a
    ``torch.Generator`` (on ``device``)."""
    return init_params(seed_or_gen, param_defs(cfg), dtype=as_dtype(cfg.dtype), device=device)


def param_specs(cfg: ArchConfig):
    return specs_of(param_defs(cfg))


def cache_defs(cfg: ArchConfig, batch: int, seq: int):
    return [group_cache_defs(cfg, batch, seq) for _ in range(cfg.num_groups)]


def cache_specs(cfg: ArchConfig, batch: int, seq: int):
    return specs_of(cache_defs(cfg, batch, seq))


def init_cache(cfg: ArchConfig, batch: int, seq: int, dtype=None, device="cuda"):
    """An all-zero cache: a list over groups of ``{"layer<i>": {"k", "v"}}``
    with ``(B, seq, Hkv, hd)`` leaves for attention layers and
    ``{"layer<i>": {"state", "conv"}}`` for SSM layers, all in ``dtype``."""
    return init_params(None, cache_defs(cfg, batch, seq),
                       dtype=as_dtype(dtype or cfg.dtype), device=as_device(device))


def _positions(cfg: ArchConfig, batch: int, seq: int, device):
    pos = torch.arange(seq, dtype=torch.int32, device=device).expand(batch, seq)
    if cfg.rope == "mrope":
        # text stream stub: t/h/w all follow the token index (apply_rope takes
        # arbitrary per-stream ids from a vision frontend)
        pos = pos[None].expand(3, batch, seq)
    return pos


def _embed_placed(w, tokens):
    """The lookup on a model mesh: each card's vocabulary block, the rows of
    other blocks zero, summed over ``"model"``."""
    from torch.distributed.tensor import DTensor
    w = placement.gathered(w)
    mesh = w.device_mesh
    names = mesh.mesh_dim_names
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [placement.Replicate()] * mesh.ndim)
    tok_pl = placement.placed_like(tokens, model=placement.Replicate())
    tokens = tokens.redistribute(mesh, tok_pl) if tok_pl != tuple(tokens.placements) else tokens
    vp = placement.axis_placement(w, "model")
    out_pl = tuple(tokens.placements)
    if not isinstance(vp, placement.Shard) or vp.dim != 0:
        rows = F.embedding(tokens.to_local(), placement.to_local_partial(w))
        return DTensor.from_local(rows, mesh, out_pl)
    blk = placement.to_local_partial(w)
    lo = mesh.get_local_rank("model") * blk.shape[0]
    t = tokens.to_local().long() - lo
    mine = (t >= 0) & (t < blk.shape[0])
    rows = F.embedding(t.clamp(0, blk.shape[0] - 1), blk) * mine[..., None].to(blk.dtype)
    part = tuple(placement.Partial() if n == "model" else p for n, p in zip(names, out_pl))
    return DTensor.from_local(rows, mesh, part).redistribute(mesh, out_pl)


def _embed(params, tokens, cfg: ArchConfig):
    if type(params["embed"]) is not torch.Tensor and placement.is_dtensor(params["embed"]):
        x = _embed_placed(params["embed"], tokens)
    else:
        x = params["embed"][tokens]
    if cfg.scale_embeddings:
        # the reference's Python-float factor takes x's dtype first (weak type)
        # (filled on the device: no blocking host-to-device copy a step)
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return hint(x, ("batch", "seq", None))


def _unembed(params, x, cfg: ArchConfig):
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    if placement.is_dtensor(w):
        w = placement.gathered(w)
        if placement.is_dtensor(x):
            want = placement.placed_like(x, model=placement.Replicate())
            x = x.redistribute(x.device_mesh, want) if want != tuple(x.placements) else x
    logits = (x @ w.to(x.dtype)).to(torch.float32)
    if cfg.final_softcap > 0:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    if cfg.padded_vocab != cfg.vocab_size:  # mask pad columns out of the lse
        iota = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = torch.where(iota < cfg.vocab_size, logits,
                             torch.full_like(logits, NEG_INF))
    return hint(logits, ("batch", "seq", "vocab"))


_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep unbatched products, recompute the rest."""
    if op in _SAVED_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _group_out(p_group, x, cfg: ArchConfig, pos):
    return group_fwd(p_group, x, cfg, pos)[0]


def _run_group(p_group, x, cfg: ArchConfig, pos):
    """One group of ``forward``, checkpointed as ``cfg.remat`` asks while
    autograd records."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return _group_out(p_group, x, cfg, pos)
    if cfg.remat_policy == "dots":
        context = functools.partial(create_selective_checkpoint_contexts, _save_products)
        return checkpoint(_group_out, p_group, x, cfg, pos, use_reentrant=False,
                          context_fn=context)
    return checkpoint(_group_out, p_group, x, cfg, pos, use_reentrant=False)


def forward(params, tokens, cfg: ArchConfig):
    """tokens: (B, S) int -> logits (B, S, V) f32."""
    b, s = tokens.shape
    x = _embed(params, tokens, cfg)
    pos = _positions(cfg, b, s, x.device)
    for p_group in params["blocks"]:
        x = _run_group(p_group, x, cfg, pos)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _unembed(params, x, cfg)


def loss_fn(params, tokens, labels, cfg: ArchConfig):
    """Causal LM cross-entropy (labels = next tokens, negative = pad)."""
    return cross_entropy(forward(params, tokens, cfg), labels)


def cross_entropy(logits, labels):
    """Mean of ``logsumexp(logits) - logits[label]`` over the positions
    whose label is >= 0 (a 0-d f32 tensor; 0 where none is)."""
    if type(logits) is not torch.Tensor and placement.is_dtensor(logits):
        return _cross_entropy_placed(logits, labels)
    valid = labels >= 0
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    return ((lse - picked) * valid).sum() / valid.sum().clamp_min(1)


def _cross_entropy_placed(logits, labels):
    """:func:`cross_entropy` of logits sharded over the vocabulary on
    ``"model"`` (and over the batch on the data axes): each card's block
    gives its max, its sum of exponentials and, where it holds the label,
    the label's logit; the sums are all-reduced with their gradients."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    mesh = logits.device_mesh
    names = mesh.mesh_dim_names
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [placement.Replicate()] * mesh.ndim)
    lab_pl = placement.placed_like(logits, model=placement.Replicate())
    labels = labels.redistribute(mesh, lab_pl) if lab_pl != tuple(labels.placements) else labels
    vp = placement.axis_placement(logits, "model")
    if not (isinstance(vp, placement.Shard) and vp.dim % logits.ndim == logits.ndim - 1):
        logits = logits.redistribute(mesh, lab_pl)
    lg, lab = logits.to_local(), labels.to_local()
    width = lg.shape[-1]
    sharded = "model" in names and logits.shape[-1] != width
    lo = mesh.get_local_rank("model") * width if sharded else 0
    part = tuple(placement.Partial() if n == "model" else p for n, p in zip(names, lab_pl))

    def over_vocab(t):  # the sum over the vocabulary blocks, with its gradient
        if not sharded:
            return t
        return DTensor.from_local(t, mesh, part).redistribute(mesh, lab_pl).to_local()

    m = lg.detach().amax(dim=-1, keepdim=True)
    if sharded:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.get_group("model"))
    se = over_vocab(torch.exp(lg - m).sum(dim=-1))
    t = lab.long() - lo
    mine = (t >= 0) & (t < width)
    picked = over_vocab(lg.gather(-1, t.clamp(0, width - 1)[..., None])[..., 0] * mine)
    lse = m[..., 0] + torch.log(se)
    valid = lab >= 0
    num = ((lse - picked) * valid).sum()
    den = valid.sum().to(torch.float32)
    # the sums over the batch blocks
    tot = tuple(placement.Partial() if isinstance(p, placement.Shard) else placement.Replicate()
                for p in lab_pl)
    num = DTensor.from_local(num, mesh, tot).full_tensor()
    if any(isinstance(p, placement.Shard) for p in lab_pl):
        den = den.clone()
        for i, p in enumerate(lab_pl):
            if isinstance(p, placement.Shard):
                dist.all_reduce(den, group=mesh.get_group(i))
    return num / den.clamp_min(1)


def _pad_seq(a, cache_len):
    """(B, S, Hkv, hd) -> (B, cache_len, Hkv, hd), zeros after S."""
    if type(a) is not torch.Tensor and placement.is_dtensor(a):
        from torch.distributed.tensor import DTensor
        pls = tuple(placement.Replicate() if isinstance(p, placement.Shard) and p.dim == 1 else p
                    for p in a.placements)
        a = a.redistribute(a.device_mesh, pls) if pls != tuple(a.placements) else a
        return DTensor.from_local(_pad_seq(a.to_local(), cache_len), a.device_mesh, pls)
    out = a.new_zeros((a.shape[0], cache_len, *a.shape[2:]))
    out[:, :a.shape[1]] = a
    return out


_KV = ("k", "v")


def prefill(params, tokens, cfg: ArchConfig, cache_len: int):
    """Forward + populate a cache of length cache_len. Returns (last-token
    logits (B, V), cache) — a list of per-group caches whose attention
    ``(B, S, Hkv, hd)`` k/v are zero-padded to ``cache_len``; SSM layers'
    ``state`` (f32) and ``conv`` are kept as they are."""
    b, s = tokens.shape
    if cache_len < s:
        raise ValueError(f"cache_len {cache_len} < prompt length {s}")
    x = _embed(params, tokens, cfg)
    pos = _positions(cfg, b, s, x.device)
    caches = []
    for p_group in params["blocks"]:
        x, group_cache = group_fwd(p_group, x, cfg, pos, collect_cache=True)
        caches.append({key: {name: _pad_seq(t, cache_len) if name in _KV else t
                             for name, t in layer.items()}
                       for key, layer in group_cache.items()})
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _unembed(params, x[:, -1:, :], cfg)
    return logits[:, 0], caches


def prefill_paged(params, tokens, cfg: ArchConfig, last):
    """Prefill for the paged serve loop: returns (logits (B, V) at position
    ``last``, UNPADDED caches).

    Prompts arrive right-padded to a bucket, so the next-token logits live
    at ``last = prompt_len - 1`` (an int or a 0-d tensor), not at ``-1``
    like :func:`prefill`; causality makes the pad tail invisible to position
    ``last``. The caches keep the bucket length ``S_pad`` — a list over
    groups of ``{"layer<i>": {"k", "v"}}``, each ``(B, S_pad, Hkv, hd)``, as
    the model wrote them — and the caller scatters the first ``prompt_len``
    token slots into its page slab, so there is no ``cache_len`` padding.
    The final norm and the head run on row ``last`` alone (both act row by
    row, so the values are those of the whole sequence's row ``last``).
    """
    b, s = tokens.shape
    x = _embed(params, tokens, cfg)
    pos = _positions(cfg, b, s, x.device)
    caches = []
    for p_group in params["blocks"]:
        x, group_cache = group_fwd(p_group, x, cfg, pos, collect_cache=True)
        caches.append(group_cache)
    if isinstance(last, torch.Tensor):      # no host sync for a device index
        x = x.index_select(1, last.to(device=x.device, dtype=torch.long).reshape(1))
    else:
        x = x[:, int(last):int(last) + 1]
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _unembed(params, x, cfg)[:, 0], caches


def decode_step_deltas(params, cache, token, cache_pos, cfg: ArchConfig):
    """One decode step against a READ-ONLY cache, returning the per-group,
    per-layer one-token deltas instead of a written-back cache.

    token: (B,) int; cache_pos: an int (whole batch at one position) or a
    (B,) tensor (continuous batching). Returns (logits (B, V), deltas) with
    deltas a list over groups of ``{"layer<i>": {"k", "v"}}``, each
    ``(B, 1, Hkv, hd)``, for attention layers and ``{"layer<i>": {"state",
    "conv"}}`` (the whole new state) for SSM layers.
    """
    x = _embed(params, token[:, None], cfg)
    deltas = []
    for p_group, cache_group in zip(params["blocks"], cache):
        x, d = group_decode_tokens(p_group, x, cfg, cache_group, cache_pos)
        deltas.append(d)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _unembed(params, x, cfg)[:, 0], deltas


def decode_step(params, cache, token, cache_pos, cfg: ArchConfig):
    """One decode step. token: (B,) int; cache_pos: the number of tokens
    already in the cache (an int, or a (B,) tensor for per-row positions).
    Returns (logits (B, V), cache) — the cache is written IN PLACE."""
    logits, deltas = decode_step_deltas(params, cache, token, cache_pos, cfg)
    return logits, apply_decode_deltas(cache, deltas, cfg, cache_pos)
