"""Distributed execution: int8 gradient compression, optionally with an
error-feedback residual, for the train step (:mod:`~repro_torch.dist.compression`).

The reference's ``dist.sharding`` (logical-axis specs, ``hint``,
``tree_shardings``, ``use_sharding``, ``estimate_fsdp``) and its names here
come with the model meshes (ROADMAP Queue A item 9b).
"""
from .compression import compress_int8, compress_tree, decompress_int8, make_grad_transform

__all__ = ["compress_int8", "compress_tree", "decompress_int8", "make_grad_transform"]
