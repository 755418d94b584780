"""AdamW with bf16 params + f32 master/moment states.

The state keeps the reference's layout. A per-group list of the param tree
(``blocks``; an encoder-decoder's ``encoder`` and ``decoder``), which the
reference holds as stacked ``(G, ...)`` leaves, is held stacked here too:
one ``(G, ...)`` master, m and v a leaf (``_tree.leaf_sets``). So
``factored_v`` factors exactly the tensors the reference factors (a
stacked norm weight ``(G, d)`` included), and the state converts to and
from the reference's leaf for leaf (``convert.train_state``, checkpoints).
Grads and params keep the port's per-group layout: ``apply_updates``
stacks each leaf's grads and hands the params back as views of the
stacked cast. Gradient clipping (global norm) and the optional gradient
transform (``dist.compression``) come before the moment update.

The arithmetic is the reference's, in f32: the schedule and the bias
corrections on an f32 step (``b1 ** step`` in f32, not in Python doubles),
every divisor a tensor (PyTorch's CUDA division by a Python scalar is a
reciprocal multiply). Unlike the reference, which returns a new state,
``apply_updates`` updates the state's master, m and v IN PLACE (granite-8b's
state is 16 B a parameter; a second copy would not fit the card).

Ported: ``AdamWConfig``, ``schedule``, ``init_state``, ``state_structs``
(as tensors on the ``meta`` device), ``state_specs`` and
``state_spec_tree`` (the state's logical axes: a stacked leaf's specs gain
the reference's leading ``"layers"`` axis, and a factored ``v`` drops an
axis), ``clip_by_global_norm``, ``apply_updates``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch._tree import at, fill, leaf_sets, nest, stack, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    # memory-reduced state (for 100B+ models where f32 m+v dominate memory):
    #   m_dtype="bfloat16"  halves the first moment;
    #   factored_v=True     stores the second moment of >=2-D (stacked)
    #                       leaves as a rank-1 (row, col) factorization
    #                       (Adafactor) — O(n+m) instead of O(n*m).
    m_dtype: str = "float32"
    factored_v: bool = False


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d f32 tensor on ``like``'s device (a divisor that
    divides truly on every device)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_frac``; a 0-d f32 tensor."""
    step = step.to(torch.float32)
    warm = step / _f32(max(1.0, cfg.warmup_steps), step)
    denom = _f32(max(1.0, cfg.total_steps - cfg.warmup_steps), step)
    t = ((step - cfg.warmup_steps) / denom).clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _factorable(p: torch.Tensor) -> bool:
    return p.ndim >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1


def _init_v(p: torch.Tensor, cfg: "AdamWConfig | None"):
    if cfg is not None and cfg.factored_v and _factorable(p):
        return {
            "row": torch.zeros_like(p[..., 0], dtype=torch.float32),     # mean over cols
            "col": torch.zeros_like(p[..., 0, :], dtype=torch.float32),
        }
    return torch.zeros_like(p, dtype=torch.float32)


def init_state(params, cfg: "AdamWConfig | None" = None) -> dict:
    """``{"master", "m", "v", "step"}``: the f32 master a copy of the params,
    zero moments (``m`` in ``cfg.m_dtype``, ``v`` factored where
    ``cfg.factored_v`` asks), ``step`` a 0-d int32 zero — every per-group
    list stacked ``(G, ...)``, on the params' device."""
    m_dtype = getattr(torch, cfg.m_dtype) if cfg is not None else torch.float32
    master, m, v = {}, {}, {}
    for path, leaf in leaf_sets(params):
        p = stack([t.to(torch.float32) for t in leaf]) if isinstance(leaf, list) \
            else leaf.to(torch.float32, copy=True)
        master[path] = p
        m[path] = torch.zeros_like(p, dtype=m_dtype)
        v[path] = _init_v(p, cfg)
    return {"master": nest(master), "m": nest(m), "v": nest(v),
            "step": torch.zeros((), dtype=torch.int32, device=p.device)}


def state_structs(params, cfg: "AdamWConfig | None" = None) -> dict:
    """The state :func:`init_state` would build for ``params`` (tensors or
    their ``meta`` twins), as tensors on the ``meta`` device: shapes and
    dtypes, no memory (the dry run's twin of ``init_state``)."""
    return init_state(tree_map(lambda p: torch.empty_like(p, device="meta"), params), cfg)


def _stacked_specs(param_specs) -> dict:
    """``{path: (spec, stacked)}``: each leaf set's logical axes in the
    state's stacked layout (a per-group list gains ``"layers"`` in front)."""
    out = {}
    for path, leaf in leaf_sets(param_specs):
        if isinstance(leaf, list):
            out[path] = (("layers", *leaf[0]), True)
        else:
            out[path] = (tuple(leaf), False)
    return out


def state_specs(param_specs) -> dict:
    """Logical-axis specs for the optimizer state (mirrors the params, each
    per-group list stacked)."""
    specs = nest({path: spec for path, (spec, _) in _stacked_specs(param_specs).items()})
    return {"master": specs, "m": specs, "v": specs, "step": ()}


def state_spec_tree(param_specs, p_structs, cfg: "AdamWConfig | None" = None) -> dict:
    """Logical-axis specs matching :func:`state_structs` of ``p_structs``
    (the params or their ``meta`` twins): a factored ``v`` drops an axis."""
    shapes = {path: ((len(leaf), *leaf[0].shape) if isinstance(leaf, list) else tuple(leaf.shape))
              for path, leaf in leaf_sets(p_structs)}
    specs = {path: spec for path, (spec, _) in _stacked_specs(param_specs).items()}

    def v_spec(path):
        spec, shape = specs[path], shapes[path]
        if cfg is not None and cfg.factored_v and len(shape) >= 2 \
                and shape[-1] > 1 and shape[-2] > 1:
            return {"row": spec[:-1], "col": spec[:-2] + spec[-1:]}
        return spec

    return {"master": nest(specs), "m": nest(specs),
            "v": nest({path: v_spec(path) for path in specs}), "step": ()}


def _global_norm(grads) -> torch.Tensor:
    sq = [t.to(torch.float32).square().sum()
          for _, leaf in leaf_sets(grads) for t in (leaf if isinstance(leaf, list) else [leaf])]
    return torch.stack(sq).sum().sqrt()


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return (_f32(max_norm, gn) / gn.clamp_min(1e-12)).clamp(max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """``(grads scaled to global norm <= max_norm, in f32; the norm)``."""
    gn = _global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), gn


def _update(cfg: AdamWConfig, master, m, v, g, lr, b1c, b2c, m_dtype):
    """One leaf's moments and master, the reference's ops in its order;
    returns the new ``m`` (``m`` itself, updated in place, where it already
    has ``m_dtype``)."""
    m32 = m.to(torch.float32).mul_(cfg.b1).add_(g * (1 - cfg.b1))
    if isinstance(v, dict):  # factored second moment (Adafactor)
        g2 = g.square().add_(1e-30)
        row = v["row"].mul_(cfg.b2).add_(g2.mean(dim=-1).mul_(1 - cfg.b2))
        col = v["col"].mul_(cfg.b2).add_(g2.mean(dim=-2).mul_(1 - cfg.b2))
        del g2
        # rank-1 reconstruction: v_ij ~= row_i * col_j / mean(row)
        denom = row.mean(dim=-1, keepdim=True).clamp_min(1e-30)
        vh = (row[..., None] * col[..., None, :] / denom[..., None]) / b2c
    else:
        vh = v.mul_(cfg.b2).add_(g.square().mul_(1 - cfg.b2)) / b2c
    upd = (m32 / b1c).div_(vh.sqrt_().add_(cfg.eps)).add_(cfg.weight_decay * master)
    master.sub_(upd.mul_(lr))
    if m.dtype == m_dtype:
        return m.copy_(m32) if m32 is not m else m
    return m32.to(m_dtype)


def apply_updates(state: dict, grads, cfg: AdamWConfig, param_dtype=torch.bfloat16,
                  grad_transform: Callable | None = None):
    """One AdamW step. Returns ``(new_params, new_state, metrics)``.

    ``grads`` is in the params' layout (per-group lists). The state's
    master, m and v are updated in place and the returned state holds them
    (a first moment whose dtype is not ``cfg.m_dtype`` yet, as after a
    ``cfg``-less ``init_state``, is replaced); ``step`` is a new tensor.
    The params are fresh ``param_dtype`` casts of the master, each group a
    view of its stacked leaf. ``metrics``: ``grad_norm`` (before clipping)
    and ``lr``, 0-d f32 tensors."""
    gnorm = _global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    if grad_transform is not None:
        grads = grad_transform(tree_map(lambda g: g.to(torch.float32) * scale, grads))
        scale = None
    step = state["step"] + 1
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(_f32(cfg.b1, stepf), stepf)
    b2c = 1 - torch.pow(_f32(cfg.b2, stepf), stepf)
    m_dtype = getattr(torch, cfg.m_dtype)
    new_m, params = {}, {}
    for path, leaf in leaf_sets(grads):
        g = stack(leaf).to(torch.float32)
        if scale is not None:
            g = g * scale
        master = at(state["master"], path)
        new_m[path] = _update(cfg, master, at(state["m"], path), at(state["v"], path), g,
                              lr, b1c, b2c, m_dtype)
        del g
        params[path] = master.to(param_dtype, copy=True)
    new_state = {"master": state["master"], "m": nest(new_m), "v": state["v"], "step": step}
    return fill(grads, params), new_state, {"grad_norm": gnorm, "lr": lr}
