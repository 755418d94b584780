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

On a model mesh (DTensor parameters, the experts sharded over ``"model"``)
every card computes the router's logits for its experts' columns; the
logits (``T x E``, an activation) are gathered, and every card routes every
token of its data block identically (top k, capacity, ranks). Each card
then dispatches to, runs and combines only its own ``E / m`` experts: its
share of each assignment's output, the others' exact zeros, is summed over
``"model"`` before the k-way sum, so the result is the one-card result bit
for bit. No card holds another's expert weights. The capacity counts the
tokens of a data block (each data-parallel replica routes its own batch).
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
    return route_logits(xt @ router.to(xt.dtype), cfg, c)


def route_logits(logits, cfg: ArchConfig, c: int):
    """:func:`route` from the router's ``(T, E)`` logits."""
    e, k = cfg.num_experts, cfg.top_k
    scores = torch.softmax(logits.to(torch.float32), dim=-1)                      # (T, E)
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
    if type(p["router"]) is not torch.Tensor:
        from repro_torch.dist.placement import is_dtensor
        if is_dtensor(p["router"]):
            return _moe_placed(p, x, cfg, capacity_factor)
    b, s, d = x.shape
    t = b * s
    k = cfg.top_k
    c = capacity(t, cfg, capacity_factor)
    # batch-major flattening: priority for capacity drops is (batch,
    # position)-ordered — position-causal within a sequence, the batch index
    # the tie-break across rows. Tests/serving-eval run dropless (C = T),
    # where order is irrelevant and decode == forward.
    xt = x.reshape(t, d)
    gates, flat_e, rank, keep = route(p["router"], xt, cfg, c)
    per_assign = _experts(xt, gates, flat_e, rank, keep, p, 0, c, cfg)
    # the k-way sum is a local reshape + reduce
    out = per_assign.reshape(t, k, d).sum(dim=1)
    return hint(out.reshape(b, s, d), ("batch", "seq", None))


def _expert_mm(spec, a, w, cfg):
    if is_quantized(w):
        from repro_torch.core.photonic_layer import psram_einsum
        return psram_einsum(spec, a, w, cfg.adc_bits).to(a.dtype)
    return torch.einsum(spec, a, w)


def _experts(xt, gates, flat_e, rank, keep, w, e0: int, c: int, cfg: ArchConfig):
    """Dispatch, expert products and combine of the routed tokens ``xt (T,
    d)`` for the experts ``e0 .. e0 + E_l`` that ``w``'s stacks hold:
    ``(T*k, d)``, each assignment's expert row times its gate, exact zeros
    where it was dropped or its expert is not among them. One card passes
    every expert (``e0 = 0``), where every assignment is its own."""
    t, d = xt.shape
    k = cfg.top_k
    e_l = (w["wi"]["q"] if is_quantized(w["wi"]) else w["wi"]).shape[0]
    mine = (flat_e >= e0) & (flat_e < e0 + e_l)
    keep = keep & mine
    e_loc = torch.where(mine, flat_e - e0, torch.zeros_like(flat_e))
    # dispatch: each kept assignment's (expert, rank) slot is unique, so the
    # reference's drop-mode scatter-add into zeros is a plain index_put_;
    # dropped assignments all land in the sacrificial slot c, sliced off
    # (which of them lands there last does not matter)
    xa = xt[:, None, :].expand(t, k, d).reshape(t * k, d)
    slot = torch.where(keep, rank, torch.full_like(rank, c))
    xe = xt.new_zeros((e_l, c + 1, d))
    xe.index_put_((e_loc, slot), xa)
    xe = hint(xe[:, :c], ("experts", None, "embed"))
    h = _expert_mm("ecd,edf->ecf", xe, w["wi"], cfg)
    if cfg.act == "swiglu":
        h = F.silu(_expert_mm("ecd,edf->ecf", xe, w["wg"], cfg)) * h
    elif cfg.act == "geglu":
        h = F.gelu(_expert_mm("ecd,edf->ecf", xe, w["wg"], cfg), approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    h = hint(h, ("experts", None, "ff"))
    ye = hint(_expert_mm("ecf,efd->ecd", h, w["wo"], cfg), ("experts", None, "embed"))
    # combine: each assignment reads its expert row (the reference's
    # fill-mode gather at min(rank, C-1)), weighted by its gate times keep
    return ye[e_loc, rank.clamp(max=c - 1)] * (
        gates.reshape(-1, 1).to(ye.dtype) * keep[:, None])


def _moe_placed(p, x, cfg: ArchConfig, capacity_factor):
    """:func:`moe_fwd` on a model mesh (see the module note)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist import placement as pl
    mesh = p["router"].device_mesh
    names = mesh.mesh_dim_names
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [pl.Replicate()] * mesh.ndim)
    x_pl = pl.placed_like(x, model=pl.Replicate())
    x = x.redistribute(mesh, x_pl) if x_pl != tuple(x.placements) else x
    router = pl.gathered(p["router"])
    logits = x @ router.to(x.dtype)                       # (B, S, E): E on "model"
    logits = logits.redistribute(mesh, x_pl) if x_pl != tuple(logits.placements) else logits
    w = {name: (pl.gathered(t) if not is_quantized(t)
                else {kk: pl.settled(pl.gathered(v)) for kk, v in t.items()})
         for name, t in p.items() if name != "router"}
    wi = w["wi"]["q"] if is_quantized(w["wi"]) else w["wi"]
    if not isinstance(pl.axis_placement(wi, "model"), pl.Shard) \
            or pl.axis_placement(wi, "model").dim != 0:
        raise ValueError(f"the experts are not sharded over 'model' ({wi.placements}); "
                         "a mesh's experts axis must divide the experts")
    x_l = pl.to_local_partial(x)
    lg = pl.to_local_partial(logits)
    local = {name: (pl.to_local_partial(t) if not is_quantized(t)
                    else {kk: pl.to_local_partial(v) for kk, v in t.items()})
             for name, t in w.items()}
    b, s, d = x_l.shape
    t = b * s
    e, k = cfg.num_experts, cfg.top_k
    c = capacity(t, cfg, capacity_factor)
    gates, flat_e, rank, keep = route_logits(lg.reshape(t, e), cfg, c)
    e0 = mesh.get_local_rank("model") * (
        local["wi"]["q"] if is_quantized(local["wi"]) else local["wi"]).shape[0]
    per_assign = _experts(x_l.reshape(t, d), gates, flat_e, rank, keep, local, e0, c, cfg)
    # one card holds each assignment's expert: the sum over "model" is exact
    part = tuple(pl.Partial() if n == "model" else q for n, q in zip(names, x_pl))
    per_assign = DTensor.from_local(per_assign.reshape(b, s * k, d), mesh, part)
    per_assign = per_assign.redistribute(mesh, x_pl).to_local()
    out = per_assign.reshape(t, k, d).sum(dim=1)
    return hint(DTensor.from_local(out.reshape(b, s, d), mesh, x_pl), ("batch", "seq", None))
