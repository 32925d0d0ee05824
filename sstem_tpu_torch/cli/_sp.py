"""Shared pieces of the SP test CLIs (``test_sp_interp``, ``test_sp_fusion``):
image reading and writing (checkpoints: ``cli/_ckpt.py``)."""

import os

import numpy as np
from PIL import Image


def read_gray(folder, name):
    """One image as a (1, H, W) uint8 array."""
    return np.asarray(Image.open(os.path.join(folder, name)))[None]


def write_png(folder, name, img01):
    """An (H, W) image in 0..1 as an 8-bit PNG (truncated, as the
    reference's ``(x * 255).astype(np.uint8)``)."""
    os.makedirs(folder, exist_ok=True)
    Image.fromarray((np.asarray(img01) * 255).astype(np.uint8)).save(
        os.path.join(folder, name))
