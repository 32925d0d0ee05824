from sstem_tpu_torch.train.schedules import poly_warmup_decay_lr
from sstem_tpu_torch.train.trainer import (
    Optimizer,
    TrainState,
    make_eval_step,
    make_optimizer,
    make_train_step,
)

__all__ = ["Optimizer", "TrainState", "make_eval_step", "make_optimizer",
           "make_train_step", "poly_warmup_decay_lr"]
