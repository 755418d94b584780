"""Training: the train step (:mod:`~repro_torch.train.step`) and the
fault-tolerant loop (:mod:`~repro_torch.train.trainer`), on one device or
on a model mesh, one process a card."""
from .step import init_train_state, make_loss_fn, make_train_step
from .trainer import Trainer

__all__ = ["Trainer", "init_train_state", "make_loss_fn", "make_train_step"]
