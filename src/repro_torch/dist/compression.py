"""Int8 gradient compression for cross-pod reduction.

Gradients crossing a slow interconnect are symmetric-int8 quantized — 4x
fewer bytes than f32 — and dequantized before the optimizer update, so the
moment math stays f32. Two flavors:

* plain (:func:`make_grad_transform`): quantize-dequantize each step; the
  per-step bias is bounded by half the quantization step;
* error feedback (:func:`compress_tree` with a residual): the quantization
  error of step t is carried and added back at step t+1 (EF-SGD), making the
  compression unbiased over time.

Scales are per-tensor by default; ``block=`` switches to per-block scales
(flattened contiguous blocks), bounding the error by each block's own step.
The codes are ``core.quantization.quantize_symmetric``'s, the reference's
run eagerly. Trees are the port's nested dicts and lists of tensors; each
leaf is compressed on its own (a per-group list as the reference's stacked
leaf), so no f32 copy of the whole tree is formed besides the two results.

Port of the reference module whole.
"""
from __future__ import annotations

import torch

from repro_torch._tree import fill, leaf_sets, stack
from repro_torch.core.quantization import quantize_symmetric


def compress_int8(g: torch.Tensor, block: int | None = None):
    """Quantize ``g`` to int8. Returns ``(q, scale)`` with ``q`` shaped like
    ``g``; ``scale`` is 0-d (per-tensor) or ``(n_blocks, 1)`` when ``block``
    is given (``g.numel()`` must divide into blocks)."""
    g32 = g.to(torch.float32)
    if block is None:
        return quantize_symmetric(g32)
    if g.numel() % block:
        raise ValueError(f"{tuple(g.shape)} does not divide into blocks of {block}")
    q, scale = quantize_symmetric(g32.reshape(-1, block), axis=1)
    return q.reshape(g.shape), scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`compress_int8` (shape-preserving), f32."""
    if scale.ndim >= 2:  # per-block scales
        deq = q.to(torch.float32).reshape(scale.shape[0], -1) * scale
        return deq.reshape(q.shape)
    return q.to(torch.float32) * scale


def compress_tree(tree, residual=None, block: int | None = None):
    """Quantize-dequantize a gradient tree, returning ``(deq, residual)``.

    ``residual`` (same structure, f32, or None) is the error-feedback carry:
    it is added to the incoming gradients before quantization, and the
    returned residual is exactly what this round failed to transmit
    (``deq + residual == grads + carried``). A per-group list (``blocks``)
    is quantized as the reference's one stacked ``(G, ...)`` leaf — one
    per-tensor scale over its groups — and comes back as views of it."""
    carried = dict(leaf_sets(residual)) if residual is not None else None
    deq, new_residual = {}, {}
    for path, leaf in leaf_sets(tree):
        g = stack(leaf).to(torch.float32)
        if carried is not None:
            g = g + stack(carried[path])
        d = decompress_int8(*compress_int8(g, block=block))
        deq[path], new_residual[path] = d, g - d
    return fill(tree, deq), fill(tree, new_residual)


def make_grad_transform(compress: bool = True, block: int | None = None):
    """Gradient transform for ``optim.apply_updates``: int8
    quantize-dequantize each leaf, or None (identity) when compression is
    off."""
    if not compress:
        return None

    def transform(grads):
        deq, _ = compress_tree(grads, block=block)
        return deq

    return transform
