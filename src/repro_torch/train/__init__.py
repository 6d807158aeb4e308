"""Training substrate: optimizer, schedules, train step, trainer loop.

The port's counterpart of the reference's ``train/``: ``optimizer``
(``OptState``, ``init_opt_state``, ``make_schedule``, ``global_norm``,
``adamw_update``), ``train_step`` (``cross_entropy``, ``make_loss_fn``,
``make_train_step``, ``make_eval_step``) and ``trainer`` (``Trainer``).
"""
from repro_torch.train.optimizer import (
    OptState,
    adamw_update,
    global_norm,
    init_opt_state,
    make_schedule,
)
from repro_torch.train.train_step import (
    cross_entropy,
    make_eval_step,
    make_loss_fn,
    make_train_step,
)
from repro_torch.train.trainer import Trainer

__all__ = ["OptState", "Trainer", "adamw_update", "cross_entropy", "global_norm",
           "init_opt_state", "make_eval_step", "make_loss_fn", "make_schedule",
           "make_train_step"]
