"""Train state, optimizer and step factories (counterpart of
``sstem_tpu/train/trainer.py``: ``TrainState``, ``make_optimizer``,
``make_train_step`` and ``make_eval_step``, without the mesh).

Optimizer parity with optax: ``Optimizer`` runs its update t (t = 0, 1, ...)
at lr = schedule(t), as optax evaluates a schedule at its update count.
With ``weight_decay`` set it is AdamW, the decoupled decay
``p <- p - lr_t * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` that optax.adamw
applies and that the reference applies by hand around torch Adam
(main_ms.py:207-210); otherwise plain Adam.
"""

from dataclasses import dataclass
from typing import Any, Callable

import torch


class Optimizer:
    """torch Adam or AdamW whose learning rate follows ``schedule``."""

    def __init__(self, params, schedule, weight_decay=None, b1=0.9, b2=0.999,
                 eps=1e-8):
        self.schedule = schedule
        self.count = 0
        kw = {"lr": float(schedule(0)), "betas": (b1, b2), "eps": eps}
        if weight_decay:
            self.inner = torch.optim.AdamW(params, weight_decay=float(weight_decay),
                                           **kw)
        else:
            self.inner = torch.optim.Adam(params, **kw)

    def zero_grad(self):
        self.inner.zero_grad(set_to_none=True)

    def step(self):
        lr = float(self.schedule(self.count))
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.count += 1

    def state_dict(self):
        """torch's optimizer state dict (the reference checkpoints'
        ``optimizer_weights``): Adam's moments and each parameter's step."""
        return self.inner.state_dict()

    def load_state_dict(self, state):
        """Restore the moments and the schedule's count (the parameters'
        step, which every update advances together)."""
        self.inner.load_state_dict(state)
        steps = [int(s["step"]) for s in self.inner.state.values()
                 if "step" in s]
        self.count = max(steps, default=0)


def make_optimizer(params, schedule, weight_decay=None, b1=0.9, b2=0.999,
                   eps=1e-8):
    """Adam (+ decoupled weight decay) with a per-update LR schedule."""
    return Optimizer(params, schedule, weight_decay, b1, b2, eps)


@dataclass
class TrainState:
    model: Any
    opt: Optimizer


def make_train_step(loss_fn: Callable):
    """Build a train step.

    loss_fn(model, batch) -> (loss, aux_dict). Returns
    step(state, batch) -> (state, metrics), which updates the model and the
    optimizer in place; ``metrics["loss"]`` is the loss as a detached 0-d
    tensor on the model's device (no host sync).
    """

    def step(state: TrainState, batch):
        state.model.train()
        state.opt.zero_grad()
        loss, aux = loss_fn(state.model, batch)
        loss.backward()
        state.opt.step()
        metrics = dict(aux)
        metrics["loss"] = loss.detach()
        return state, metrics

    return step


def make_eval_step(model):
    """Inference step: batch -> prediction, in eval mode, without autograd."""

    @torch.inference_mode()
    def eval_fn(batch):
        model.eval()
        return model(batch)

    return eval_fn
