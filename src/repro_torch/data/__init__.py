"""The training data pipeline (:mod:`~repro_torch.data.pipeline`) and the
synthetic tensors of the CP-ALS / MTTKRP experiments
(:mod:`~repro_torch.data.tensors`: ``lowrank_dense``, ``sparse_coo``)."""
from .pipeline import DataConfig, DataIterator, batch_at_step
from .tensors import lowrank_dense, sparse_coo

__all__ = ["DataConfig", "DataIterator", "batch_at_step", "lowrank_dense", "sparse_coo"]
