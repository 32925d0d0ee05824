"""Shared pieces of the SP test CLIs (``test_sp_interp``, ``test_sp_fusion``):
checkpoint loading, image reading and writing."""

import os

import numpy as np
from PIL import Image

from sstem_tpu_torch.compat import load_reference
from sstem_tpu_torch.models.layers import skip_init
from sstem_tpu_torch.train.checkpoint import restore_checkpoint


def load_model(build, path):
    """``build()`` (a module, with no initial values drawn) loaded strictly
    from a reference-format torch checkpoint: a file, or a directory whose
    latest ``model-NNNNNN.ckpt`` is taken."""
    with skip_init():
        module = build()
    if os.path.isdir(path):
        payload = restore_checkpoint(path)
        if payload is None:
            raise FileNotFoundError(f"no model-NNNNNN.ckpt under {path}")
        return load_reference(module, payload)
    return load_reference(module, path)


def read_gray(folder, name):
    """One image as a (1, H, W) uint8 array."""
    return np.asarray(Image.open(os.path.join(folder, name)))[None]


def write_png(folder, name, img01):
    """An (H, W) image in 0..1 as an 8-bit PNG (truncated, as the
    reference's ``(x * 255).astype(np.uint8)``)."""
    os.makedirs(folder, exist_ok=True)
    Image.fromarray((np.asarray(img01) * 255).astype(np.uint8)).save(
        os.path.join(folder, name))
