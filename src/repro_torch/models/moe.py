"""Mixture-of-Experts: token-choice top-k routing, position-priority capacity.

Matches the HF reference semantics (granite-moe / dbrx / jamba are all
token-choice): each token picks its top_k experts; each expert serves at most
C = ceil(T·top_k/E · capacity_factor) tokens, and overflow is dropped in
*position order* (later tokens lose first). Position-priority makes routing
exactly causal — a token's computation can never depend on later tokens — so
prefill and decode agree whenever no drop occurs (and drops only ever
remove, never change, earlier tokens' compute).

Static shapes throughout: dispatch/combine are scatter/gather into an
(E, C, d) buffer, so FLOPs are honest (top_k·capacity_factor per token),
and no tensor's shape depends on the routing (the dispatch sends dropped
assignments to a sacrificial slot C of an (E, C + 1, d) buffer and slices
it off), so the block traces on the ``meta`` device. The
``dist.sharding.hint`` annotations (the expert axis on the "model" mesh
axis) sit where the reference's do. With ``psram_stored_int8`` the
experts' products run through
:func:`~repro_torch.core.photonic_layer.psram_einsum`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import hint

from .config import ArchConfig
from .layers import ddef, is_quantized, wdef

CAPACITY_FACTOR = 1.25


def moe_defs(cfg: ArchConfig):
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.d_ff_expert or cfg.d_ff
    defs = {
        "router": ddef((d, e), ("embed", "experts")),
        "wi": wdef(cfg, (e, d, ff), ("experts", "embed", "ff")),
        "wo": wdef(cfg, (e, ff, d), ("experts", "ff", "embed")),
    }
    if cfg.act in ("swiglu", "geglu"):
        defs["wg"] = wdef(cfg, (e, d, ff), ("experts", "embed", "ff"))
    return defs


def capacity(tokens: int, cfg: ArchConfig, factor: float | None = CAPACITY_FACTOR) -> int:
    if factor is None:  # dropless: every expert can serve every token
        return tokens
    return max(1, min(tokens, math.ceil(tokens * cfg.top_k / cfg.num_experts * factor)))


def route(router, xt, cfg: ArchConfig, c: int):
    """Token-choice top-k routing of ``xt (T, d)`` at capacity ``c``:
    ``(gates (T, k) f32, flat_e (T*k,), rank (T*k,), keep (T*k,))``.

    The top k is taken from a stable descending sort, so among equal scores
    the lower expert index comes first, as in ``jax.lax.top_k``. ``rank`` is
    each assignment's exclusive count of earlier (token-major) assignments
    to its expert, formed in float32 as in the reference (exact below 2^24
    assignments); ``keep`` is ``rank < c``.
    """
    e, k = cfg.num_experts, cfg.top_k
    scores = torch.softmax((xt @ router.to(xt.dtype)).to(torch.float32), dim=-1)   # (T, E)
    gates, eidx = torch.sort(scores, dim=-1, descending=True, stable=True)
    gates, eidx = gates[:, :k], eidx[:, :k]                                        # (T, k)
    flat_e = eidx.reshape(-1)                           # (T*k,) row-major: token-major
    # expert-major (E, T*k), so the count runs along the contiguous axis:
    # down the long axis of a (T*k, E) matrix the scan took 11.6 ms a layer
    # on an H100 at a 65,536 x 32 prefill; every partial count is an exact
    # integer either way
    onehot = F.one_hot(flat_e, e).T.to(torch.float32).contiguous()
    rank = torch.cumsum(onehot, dim=1) - onehot         # exclusive count
    rank = (rank * onehot).sum(dim=0).to(torch.int64)   # (T*k,)
    return gates, flat_e, rank, rank < c


def moe_fwd(p, x, cfg: ArchConfig, capacity_factor: float | None = "cfg"):
    """x: (B, S, D) -> (B, S, D)."""
    if capacity_factor == "cfg":
        capacity_factor = cfg.moe_capacity_factor
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.top_k
    c = capacity(t, cfg, capacity_factor)
    # batch-major flattening: priority for capacity drops is (batch,
    # position)-ordered — position-causal within a sequence, the batch index
    # the tie-break across rows. Tests/serving-eval run dropless (C = T),
    # where order is irrelevant and decode == forward.
    xt = x.reshape(t, d)
    gates, flat_e, rank, keep = route(p["router"], xt, cfg, c)

    # dispatch: each kept assignment's (expert, rank) slot is unique, so the
    # reference's drop-mode scatter-add into zeros is a plain index_put_;
    # dropped assignments all land in the sacrificial slot c, sliced off
    # (which of them lands there last does not matter)
    xa = xt[:, None, :].expand(t, k, d).reshape(t * k, d)
    slot = torch.where(keep, rank, torch.full_like(rank, c))
    xe = xt.new_zeros((e, c + 1, d))
    xe.index_put_((flat_e, slot), xa)
    xe = hint(xe[:, :c], ("experts", None, "embed"))

    def expert_mm(spec, a, w):
        if is_quantized(w):
            from repro_torch.core.photonic_layer import psram_einsum
            return psram_einsum(spec, a, w, cfg.adc_bits).to(a.dtype)
        return torch.einsum(spec, a, w)

    h = expert_mm("ecd,edf->ecf", xe, p["wi"])
    if cfg.act == "swiglu":
        h = F.silu(expert_mm("ecd,edf->ecf", xe, p["wg"])) * h
    elif cfg.act == "geglu":
        h = F.gelu(expert_mm("ecd,edf->ecf", xe, p["wg"]), approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    h = hint(h, ("experts", None, "ff"))
    ye = hint(expert_mm("ecf,efd->ecd", h, p["wo"]), ("experts", None, "embed"))   # (E, C, D)

    # combine: each assignment reads its expert row (the reference's
    # fill-mode gather at min(rank, C-1)), weighted by its gate times keep;
    # the k-way sum is a local reshape + reduce
    per_assign = ye[flat_e, rank.clamp(max=c - 1)] * (
        gates.reshape(-1, 1).to(ye.dtype) * keep[:, None])
    out = per_assign.reshape(t, k, d).sum(dim=1)
    return hint(out.reshape(b, s, d), ("batch", "seq", None))
