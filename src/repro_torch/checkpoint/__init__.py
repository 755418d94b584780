"""Atomic, asynchronous checkpoints in the reference's on-disk format
(:mod:`~repro_torch.checkpoint.manager`)."""
from .manager import CheckpointError, CheckpointManager

__all__ = ["CheckpointError", "CheckpointManager"]
