"""Shared training loop (counterpart of ``sstem_tpu/train/loop.py``:
``run_training``, ``to_uint8`` and ``save_collage``).

The reference loop surface (main_ms.py:138-288): per-step loss logging to
the console, ``loss.txt`` and tensorboard; PNG preview collages at
``display_freq``; validation at ``save_freq`` (scores to ``valid.txt`` and
tensorboard); ``model-%06d.ckpt`` saves, always including the last step.
The host syncs with the card only at those boundaries (the loss is read
there); between them the steps queue on the card's stream.
"""

import logging
import os
import time

import numpy as np

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
                 display_freq=100, save_freq=1000,
                 valid_fn=None, preview_fn=None, writer=None,
                 logger=None, start_iter=0, schedule=None):
    """Run the training loop. Returns the final state.

    valid_fn(state, iters) -> (scalar, name)
    preview_fn(state, batch, iters) -> None (writes collages to cache_path)
    schedule: optional fn step -> lr, logged only.
    """
    logger = logger or logging.getLogger("sstem_tpu_torch")
    os.makedirs(cache_path, exist_ok=True)
    os.makedirs(save_path, exist_ok=True)
    if valid_path:
        os.makedirs(valid_path, exist_ok=True)
    with open(os.path.join(cache_path, "loss.txt"), "a") as f_loss, \
            open(os.path.join(cache_path, "valid.txt"), "a") as f_valid:
        iters = start_iter
        sum_time = 0.0
        while iters < total_iters:
            iters += 1
            t1 = time.time()
            batch = provider.next()
            state, metrics = train_step(state, batch)
            if iters % display_freq == 0 or iters == 1:
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

            if valid_fn is not None and (iters % save_freq == 0 or iters == 1):
                score, name = valid_fn(state, iters)
                line = "model-%d, valid-%s=%.6f" % (iters, name, score)
                logger.info(line)
                f_valid.write(line + "\n")
                f_valid.flush()
                if writer is not None:
                    writer.add_scalar(name, score, iters)

            # always checkpoint the final iteration, even off the save_freq grid
            if iters % save_freq == 0 or iters == total_iters:
                save_checkpoint(save_path, iters, state.model.state_dict())
                logger.info("saved checkpoint at iters = %d", iters)
    return state
