"""Learning-rate schedules (counterpart of ``sstem_tpu/train/schedules.py``:
``poly_warmup_decay_lr`` and ``step_lr``).

The SFF trainers' schedule (calculate_lr, sff_scripts_interp/main_ms.py:
127-135): polynomial warmup from end_lr to base_lr over ``warmup_iters``,
then polynomial decay back to end_lr over ``decay_iters``, then constant
end_lr. The SP trainers' schedule is torch's StepLR stepped once an epoch
(sp_scripts_train/main_interp.py): base_lr * gamma^(epoch // step_size).
Each is evaluated in float32, as the JAX schedules are, and returns a
Python float. The optimizer evaluates it at its update count, which starts
at 0 (``train/trainer.py``).
"""

import numpy as np


def poly_warmup_decay_lr(base_lr, end_lr, warmup_iters, decay_iters,
                         power=1.5):
    """Returns a schedule fn: step -> lr (float)."""
    base_lr = float(base_lr)
    end_lr = float(end_lr)

    def schedule(step):
        it = np.float32(step)
        if it < warmup_iters:
            lr = (base_lr - end_lr) * np.power(it / warmup_iters, power) + end_lr
        elif it < decay_iters:
            lr = (base_lr - end_lr) * np.power(
                np.maximum(1.0 - (it - warmup_iters) / decay_iters,
                           np.float32(0.0)), power) + end_lr
        else:
            lr = end_lr
        return float(np.float32(lr))

    return schedule


def step_lr(base_lr, step_size=30, gamma=0.5, steps_per_epoch=1):
    """torch StepLR parity: lr = base * gamma^(epoch // step_size), the epoch
    being step // steps_per_epoch. Returns a schedule fn: step -> lr
    (float)."""
    base_lr = np.float32(base_lr)
    gamma = np.float32(gamma)

    def schedule(step):
        epoch = np.float32(step) // np.float32(steps_per_epoch)
        lr = base_lr * np.power(gamma, np.floor(epoch / np.float32(step_size)))
        # XLA flushes float32 subnormals to zero (a 1e-20 branch weight
        # reaches them after some 50 halvings)
        return float(lr) if lr >= np.finfo(np.float32).tiny else 0.0

    return schedule
