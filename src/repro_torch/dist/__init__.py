"""Distributed execution: logical-axis sharding, placement and gradient compression.

``dist.sharding`` maps logical tensor axes ("batch", "ff", "kv_heads", ...)
onto mesh axes ("pod", "data", "model") with priority-ordered assignment and
divisibility fallback; models annotate activations with :func:`hint`, and
the dry run builds its per-device shardings with :func:`tree_shardings`
under a :func:`use_sharding` context. ``dist.placement`` turns those specs
into DTensor placements over a ``DeviceMesh`` (one process a card): it
places parameters, state, caches and batches, and a hint redistributes an
activation. ``dist.compression`` provides int8
gradient compression (optionally with an error-feedback residual) for the
train step.
"""
from .compression import compress_int8, compress_tree, decompress_int8, make_grad_transform
from .sharding import estimate_fsdp, hint, logical_to_spec, tree_shardings, use_sharding

__all__ = ["compress_int8", "compress_tree", "decompress_int8", "estimate_fsdp", "hint",
           "logical_to_spec", "make_grad_transform", "tree_shardings", "use_sharding"]
