"""The training data pipeline (:mod:`~repro_torch.data.pipeline`). The
reference's synthetic tensors (``data.tensors``: ``lowrank_dense``,
``sparse_coo``) come with the benchmark cells (ROADMAP Queue A item 10a)."""
from .pipeline import DataConfig, DataIterator, batch_at_step

__all__ = ["DataConfig", "DataIterator", "batch_at_step"]
