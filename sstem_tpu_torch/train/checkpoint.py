"""Checkpoints in the reference's payload (counterpart of
``sstem_tpu/train/checkpoint.py``; orbax is not ported).

A checkpoint is one ``torch.save`` file, ``model-%06d.ckpt``, holding the
reference trainers' dict: ``current_iter``, ``model_weights`` (the state
dict, with the reference's key names) and, when given,
``optimizer_weights`` and ``valid_result`` (SURVEY §2.8). Reference tools,
the port's ``compat.weights.load_reference`` and the JAX package's
``compat.torch_ckpt`` importers all read it. ``latest_step`` is the
regex-max auto-resume (sp_scripts_train/main_correction.py:62-76).
"""

import os
import re

import torch


def _ckpt_path(save_path, step):
    return os.path.join(os.path.abspath(save_path), "model-%06d.ckpt" % step)


def save_checkpoint(save_path, step, model_weights, opt_state=None,
                    valid_result=None):
    """Write ``model-%06d.ckpt``; tensors are saved from the CPU."""
    payload = {
        "current_iter": step,
        "model_weights": {k: v.detach().cpu() for k, v in model_weights.items()},
    }
    if opt_state is not None:
        payload["optimizer_weights"] = opt_state
    if valid_result is not None:
        payload["valid_result"] = valid_result
    path = _ckpt_path(save_path, step)
    torch.save(payload, path)
    return path


def restore_checkpoint(save_path, step=None):
    """Load a checkpoint's payload onto the CPU; step=None picks the latest.
    Returns None when there is none."""
    if step is None:
        step = latest_step(save_path)
        if step is None:
            return None
    return torch.load(_ckpt_path(save_path, step), map_location="cpu",
                      weights_only=True)


def latest_step(save_path):
    """Max step among model-NNNNNN.ckpt entries (auto-resume)."""
    if not os.path.isdir(save_path):
        return None
    steps = []
    for name in os.listdir(save_path):
        m = re.fullmatch(r"model-(\d+)\.ckpt", name)
        if m:
            steps.append(int(m.group(1)))
    return max(steps) if steps else None
