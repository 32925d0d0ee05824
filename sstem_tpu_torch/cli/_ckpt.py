"""Checkpoint loading for the inference CLIs (counterpart of
``sstem_tpu/cli/_ckpt.py``, reference-format torch checkpoints only; orbax
is not ported)."""

import os

from sstem_tpu_torch.compat import load_reference
from sstem_tpu_torch.models.layers import skip_init
from sstem_tpu_torch.train.checkpoint import restore_checkpoint


def load_model(build, path):
    """``build()`` (a module, with no initial values drawn) loaded strictly
    from a reference-format torch checkpoint: a file, or a directory whose
    newest ``model-NNNNNN.ckpt`` (the port trainer's) is taken."""
    with skip_init():
        module = build()
    if os.path.isdir(path):
        payload = restore_checkpoint(path)
        if payload is None:
            raise FileNotFoundError(f"no model-NNNNNN.ckpt under {path}")
        return load_reference(module, payload)
    return load_reference(module, path)
