"""Training step: loss and gradients, microbatch accumulation, optimizer
update.

``make_train_step`` builds the step for any registry arch. The gradient is
``torch.autograd.grad`` of the loss with respect to the params (each a
detached leaf that requires grad for the call). Microbatches run as a loop
that accumulates the gradients in f32 — the counterpart of the reference's
``lax.scan`` — and the optimizer update is ``optim.apply_updates``,
optionally with int8 gradient compression (plain, or error feedback with
the residual threaded through the step).

pSRAM projections (``cfg.psram_projections``) train with the reference's
gradient: through the scales only (its codes come from ``round``), so a
projection's weight gets a gradient at each column's ``max|w|`` and its
input at each row's ``max|x|`` (kernel 2's ``psram_matmul_trained``). With
``psram_stored_int8`` the params hold int8 words, which the reference's
``jax.grad`` refuses with a ``TypeError``; so does this step.

Port of the reference module whole.
"""
from __future__ import annotations

import torch

from repro_torch._tree import leaf_sets, leaves, path_str, tree_map
from repro_torch.dist.compression import compress_tree, make_grad_transform
from repro_torch.models.layers import as_dtype, dtypes_of
from repro_torch.models.registry import get_module
from repro_torch.optim import AdamWConfig, apply_updates, init_state


def make_loss_fn(cfg):
    """``loss(params, batch)``: the family's ``loss_fn`` on ``batch["tokens"]``
    and ``batch["labels"]`` (and, for the encoder-decoder, ``batch["frames"]``)."""
    mod = get_module(cfg)
    if cfg.family == "encdec":
        def loss(params, batch):
            return mod.loss_fn(params, batch["frames"], batch["tokens"], batch["labels"], cfg)
    else:
        def loss(params, batch):
            return mod.loss_fn(params, batch["tokens"], batch["labels"], cfg)
    return loss


def int8_leaves(cfg) -> list[str]:
    """The paths of the int8 leaves of ``cfg``'s params, in the reference's
    leaf order (a per-group list is one leaf, as the reference stacks it)."""
    defs = get_module(cfg).param_defs(cfg)
    return [path_str(path) for path, d in leaf_sets(dtypes_of(defs))
            if (d[0] if isinstance(d, list) else d) == "int8"]


def _value_and_grad(loss_fn, params, batch):
    """``(loss, grads)``: the loss detached, the grads in the params' layout
    and dtypes (zeros for a param the loss does not reach, as ``jax.grad``)."""
    tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = loss_fn(tracked, batch)
    grads = iter(torch.autograd.grad(loss, leaves(tracked), allow_unused=True,
                                     materialize_grads=True))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def make_train_step(cfg, opt_cfg: AdamWConfig, microbatches: int = 1,
                    compress_grads: bool = False, error_feedback: bool = False):
    """Returns ``train_step(params, opt_state, batch)``.

    ``batch`` is a dict of tensors with leading dim = global batch; with
    ``microbatches > 1`` they are split ``(microbatches, global_batch //
    microbatches, ...)`` and the grads accumulate in f32 over a loop.

    With ``error_feedback=True`` the int8 compression residual is threaded
    through the step (EF-SGD): the quantization error of step t is added
    back to the gradients of step t+1, making compression unbiased over
    time. The signature becomes ``step(params, opt, batch, residual) ->
    (params, opt, metrics, new_residual)``; ``residual`` mirrors the params
    in f32 (zeros at first). ``metrics``: ``loss``, ``grad_norm``, ``lr``
    (0-d f32 tensors). The optimizer state is updated in place
    (``optim.apply_updates``).
    """
    int8 = int8_leaves(cfg)
    if int8:
        raise TypeError(
            f"grad requires real- or complex-valued inputs; the params hold int8 leaves "
            f"(psram_stored_int8): {', '.join(int8[:4])}{' ...' if len(int8) > 4 else ''} "
            f"({len(int8)} in all), as the reference's jax.grad refuses them")
    loss_fn = make_loss_fn(cfg)
    transform = make_grad_transform(compress_grads and not error_feedback)
    pdtype = as_dtype(cfg.dtype)

    def accumulate(params, batch):
        """(loss, grads) over the global batch, summed over microbatches."""
        if microbatches == 1:
            return _value_and_grad(loss_fn, params, batch)
        mb = {k: x.reshape(microbatches, x.shape[0] // microbatches, *x.shape[1:])
              for k, x in batch.items()}
        lsum, gsum = None, None
        for i in range(microbatches):
            loss, g = _value_and_grad(loss_fn, params, {k: x[i] for k, x in mb.items()})
            if gsum is None:
                lsum, gsum = loss, tree_map(lambda x: x.to(torch.float32), g)
            else:
                lsum = lsum + loss
                gsum = tree_map(lambda a, x: a.add_(x.to(torch.float32)), gsum, g)
        n = torch.full((), microbatches, dtype=torch.float32, device=lsum.device)
        return lsum / n, tree_map(lambda g: g.div_(n), gsum)

    if error_feedback:
        def step_ef(params, opt_state, batch, residual):
            loss, grads = accumulate(params, batch)
            deq, new_residual = compress_tree(grads, residual)
            del grads
            params, opt_state, metrics = apply_updates(opt_state, deq, opt_cfg,
                                                       param_dtype=pdtype)
            metrics["loss"] = loss
            return params, opt_state, metrics, new_residual

        return step_ef

    def step(params, opt_state, batch):
        loss, grads = accumulate(params, batch)
        params, opt_state, metrics = apply_updates(
            opt_state, grads, opt_cfg, param_dtype=pdtype, grad_transform=transform)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


def init_train_state(seed_or_gen, cfg, opt_cfg: AdamWConfig | None = None, device="cuda"):
    """``(params, opt_state)``: random params from a seed or a
    ``torch.Generator`` (on ``device``) and a fresh optimizer state."""
    params = get_module(cfg).init(seed_or_gen, cfg, device=device)
    return params, init_state(params, opt_cfg)
