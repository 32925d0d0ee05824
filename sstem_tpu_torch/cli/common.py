"""Shared CLI plumbing (counterpart of ``sstem_tpu/cli/common.py``:
``init_project`` and ``seed_everything``).

Mirrors init_project in the reference trainers (main_ms.py:32-78): a
timestamped experiment name, file+console logging, an optional tensorboardX
SummaryWriter, and the cache/save/record/valid directory tree.
"""

import logging
import os
import sys
import time

import numpy as np


def init_project(cfg_name, cache_root, save_root, timestamp=True):
    if timestamp:
        t = time.strftime("%Y-%m-%d--%H-%M-%S", time.localtime())
        exp_name = f"{t}_{cfg_name}"
    else:
        exp_name = cfg_name
    paths = {
        "cache_path": os.path.join(cache_root, exp_name),
        "save_path": os.path.join(save_root, exp_name),
    }
    paths["record_path"] = paths["cache_path"]
    paths["valid_path"] = os.path.join(paths["cache_path"], "valid")
    for p in paths.values():
        os.makedirs(p, exist_ok=True)

    logger = logging.getLogger("sstem_tpu_torch")
    logger.setLevel(logging.INFO)
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
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
    if seed is None or seed == -1:
        return np.random.default_rng()
    return np.random.default_rng(seed)
