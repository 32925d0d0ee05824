"""Train state, optimizer and step factories (counterpart of
``sstem_tpu/train/trainer.py``: ``TrainState``, ``make_optimizer``,
``make_train_step`` and ``make_eval_step``).

The JAX step's mesh is a process group here: under one, the step's model
is a ``DistributedDataParallel`` wrapper (``parallel.ddp.wrap``), each rank
steps on its rows of the global batch, the backward averages the gradient
over the ranks, and the step reports the loss's mean over the ranks, as
the JAX step reports the global batch's (``parallel.ddp``).

Optimizer parity with optax: ``Optimizer`` runs its update t (t = 0, 1, ...)
at lr = schedule(t), as optax evaluates a schedule at its update count.
With ``weight_decay`` set it is AdamW, the decoupled decay
``p <- p - lr_t * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` that optax.adamw
applies and that the reference applies by hand around torch Adam
(main_ms.py:207-210); otherwise plain Adam. Parameter groups may each carry
their own schedule (the SP fusion trainer's per-branch learning rates, as
the JAX trainer's ``optax.multi_transform`` of one Adam per branch).
"""

from dataclasses import dataclass
from typing import Any, Callable

import torch

from sstem_tpu_torch.parallel.ddp import all_mean


class Optimizer:
    """torch Adam or AdamW whose learning rate follows ``schedule``.

    ``params`` is an iterable of tensors, or of torch param-group dicts; a
    group's ``"schedule"`` key, where given, replaces ``schedule`` for that
    group. The schedules live here, not in torch's param groups, so the
    state dict holds tensors and numbers only."""

    def __init__(self, params, schedule=None, weight_decay=None, b1=0.9,
                 b2=0.999, eps=1e-8):
        groups = list(params)
        if not (groups and isinstance(groups[0], dict)):
            groups = [{"params": groups}]
        groups = [dict(g) for g in groups]
        self.schedules = [g.pop("schedule", schedule) for g in groups]
        for g, sched in zip(groups, self.schedules):
            g["lr"] = float(sched(0))
        self.count = 0
        kw = {"betas": (b1, b2), "eps": eps}
        if weight_decay:
            self.inner = torch.optim.AdamW(groups, weight_decay=float(weight_decay),
                                           **kw)
        else:
            self.inner = torch.optim.Adam(groups, **kw)

    def zero_grad(self):
        self.inner.zero_grad(set_to_none=True)

    def step(self):
        for group, sched in zip(self.inner.param_groups, self.schedules):
            group["lr"] = float(sched(self.count))
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
    tensor on the model's device (no host sync), under a process group its
    mean over the ranks (one all-reduce).
    """

    def step(state: TrainState, batch):
        state.model.train()
        state.opt.zero_grad()
        loss, aux = loss_fn(state.model, batch)
        loss.backward()
        state.opt.step()
        metrics = dict(aux)
        metrics["loss"] = all_mean(loss.detach())
        return state, metrics

    return step


def make_eval_step(model):
    """Inference step: batch -> prediction, in eval mode, without autograd."""

    @torch.inference_mode()
    def eval_fn(batch):
        model.eval()
        return model(batch)

    return eval_fn
