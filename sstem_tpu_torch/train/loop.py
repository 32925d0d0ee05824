"""Shared training loop (counterpart of ``sstem_tpu/train/loop.py``:
``run_training``, ``to_uint8`` and ``save_collage``).

The reference loop surface (main_ms.py:138-288): per-step loss logging to
the console, ``loss.txt`` and tensorboard; PNG preview collages at
``display_freq``; validation at ``save_freq`` (scores to ``valid.txt`` and
tensorboard); ``model-%06d.ckpt`` saves, always including the last step,
with the optimizer's state when ``save_optimizer`` is set.
The host syncs with the card only at those boundaries (the loss is read
there); between them the steps queue on the card's stream.

Under a process group every rank steps, and rank 0 alone writes the files,
the tensorboard scalars and the previews, validates (on the module inside
the DDP wrapper, whose eval mode makes no collective call) and saves the
checkpoints, which hold that module's state dict (the one-process run's
keys). The other ranks wait at a barrier while rank 0 validates or saves.
"""

import contextlib
import logging
import os
import time

import numpy as np

from sstem_tpu_torch.parallel import ddp
from sstem_tpu_torch.train.checkpoint import save_checkpoint


def to_uint8(img01):
    img = np.asarray(img01)
    img = np.clip(img, 0.0, 1.0)
    return (img * 255).astype(np.uint8)


def save_collage(path, rows):
    """rows: list of lists of 2-D uint8 arrays -> one PNG grid."""
    from PIL import Image

    grid = np.concatenate(
        [np.concatenate(r, axis=1) for r in rows], axis=0
    )
    Image.fromarray(grid).save(path)


def run_training(*, provider, train_step, state, total_iters,
                 cache_path, save_path, valid_path=None,
                 display_freq=100, valid_freq=100, save_freq=1000,
                 valid_fn=None, preview_fn=None, writer=None,
                 logger=None, start_iter=0, save_optimizer=False,
                 schedule=None):
    """Run the training loop. Returns the final state.

    Validation runs at step 1 and every ``save_freq`` steps, as in the JAX
    loop (which takes ``valid_freq`` and, like the reference, validates on
    the save grid).

    valid_fn(state, iters) -> (scalar, name)
    preview_fn(state, batch, iters) -> None (writes collages to cache_path)
    schedule: optional fn step -> lr, logged only.
    """
    logger = logger or logging.getLogger("sstem_tpu_torch")
    lead = ddp.rank() == 0
    with contextlib.ExitStack() as files:
        if lead:
            os.makedirs(cache_path, exist_ok=True)
            os.makedirs(save_path, exist_ok=True)
            if valid_path:
                os.makedirs(valid_path, exist_ok=True)
            f_loss, f_valid = (
                files.enter_context(open(os.path.join(cache_path, name), "a"))
                for name in ("loss.txt", "valid.txt"))
        iters = start_iter
        sum_time = 0.0
        while iters < total_iters:
            iters += 1
            t1 = time.time()
            batch = provider.next()
            state, metrics = train_step(state, batch)
            if lead and (iters % display_freq == 0 or iters == 1):
                loss = float(metrics["loss"])  # device sync at display boundary
                sum_time += time.time() - t1
                lr = float(schedule(iters)) if schedule else float("nan")
                denom = display_freq if iters > 1 else 1
                per_step = sum_time / max(denom, 1)
                line = (
                    "step %d, loss = %.6f (lr: %.8f, et: %.2f sec, "
                    "rd: %.2f min)" % (
                        iters, loss, lr, sum_time,
                        (total_iters - iters) * per_step / 60,
                    )
                )
                logger.info(line)
                f_loss.write(line + "\n")
                f_loss.flush()
                if writer is not None:
                    writer.add_scalar("loss", loss, iters)
                sum_time = 0.0
                if preview_fn is not None:
                    preview_fn(state, batch, iters)

            validate = valid_fn is not None and (iters % save_freq == 0
                                                 or iters == 1)
            if lead and validate:
                score, name = valid_fn(state, iters)
                line = "model-%d, valid-%s=%.6f" % (iters, name, score)
                logger.info(line)
                f_valid.write(line + "\n")
                f_valid.flush()
                if writer is not None:
                    writer.add_scalar(name, score, iters)

            # always checkpoint the final iteration, even off the save_freq grid
            save = iters % save_freq == 0 or iters == total_iters
            if lead and save:
                save_checkpoint(
                    save_path, iters, ddp.unwrap(state.model).state_dict(),
                    opt_state=state.opt.state_dict() if save_optimizer else None)
                logger.info("saved checkpoint at iters = %d", iters)
            if validate or save:
                ddp.barrier()
    return state
