"""Shared CLI plumbing (counterpart of ``sstem_tpu/cli/common.py``:
``init_project`` and ``seed_everything``; and ``rank_device``, which joins
a torchrun job's process group).

Mirrors init_project in the reference trainers (main_ms.py:32-78): a
timestamped experiment name, file+console logging, an optional tensorboardX
SummaryWriter, and the cache/save/record/valid directory tree. Under a
process group rank 0 alone writes files; the others log warnings to the
console only.
"""

import logging
import os
import sys
import time

import numpy as np

from sstem_tpu_torch.parallel import ddp


def rank_device(device, backend=None):
    """The device this process trains on, and whether it joined a process
    group for this run.

    Under torchrun (WORLD_SIZE > 1 in the environment, and no group yet)
    it joins the group (``ddp.init_process_group``: ``backend`` or the
    device's default) and returns this rank's device; the caller leaves
    with ``ddp.teardown()``. Otherwise ``device`` as given: one process,
    or a group that the caller's caller made (``parallel.launch.spawn``).
    """
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not ddp.is_distributed():
        return ddp.init_process_group(backend, device=device), True
    return device, False


def init_project(cfg_name, cache_root, save_root, timestamp=True):
    if timestamp:
        t = time.strftime("%Y-%m-%d--%H-%M-%S", time.localtime())
        exp_name = f"{t}_{cfg_name}"
    else:
        exp_name = cfg_name
    # one name for every rank: theirs may differ by a second
    exp_name = ddp.broadcast_object(exp_name)
    lead = ddp.rank() == 0
    paths = {
        "cache_path": os.path.join(cache_root, exp_name),
        "save_path": os.path.join(save_root, exp_name),
    }
    paths["record_path"] = paths["cache_path"]
    paths["valid_path"] = os.path.join(paths["cache_path"], "valid")
    if lead:
        for p in paths.values():
            os.makedirs(p, exist_ok=True)

    logger = logging.getLogger("sstem_tpu_torch")
    logger.setLevel(logging.INFO if lead else logging.WARNING)
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    if not lead:
        logger.addHandler(logging.StreamHandler(sys.stdout))
        return exp_name, paths, logger, None
    fh = logging.FileHandler(os.path.join(paths["record_path"], "log.txt"))
    sh = logging.StreamHandler(sys.stdout)
    fmt = logging.Formatter("%(asctime)s %(message)s")
    fh.setFormatter(fmt)
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)

    writer = None
    try:
        from tensorboardX import SummaryWriter
    except ImportError:  # tensorboardX is optional
        pass
    else:
        writer = SummaryWriter(os.path.join(paths["record_path"], "tensorboard"))
    return exp_name, paths, logger, writer


def seed_everything(seed):
    """The run's numpy rng: unseeded for a seed of None or -1, except under
    a process group, where every rank takes rank 0's fresh seed."""
    seed = ddp.shared_seed(seed)
    if seed is None or seed == -1:
        return np.random.default_rng()
    return np.random.default_rng(seed)
