"""Padding to the model stride (counterpart of ``sstem_tpu/infer/tiles.py``:
``pad_to_multiple``)."""

import torch.nn.functional as F


def pad_to_multiple(x, multiple):
    """Edge-pad the spatial dims of (N, H, W, C) up to a stride multiple.

    Returns (padded, (h, w)) with the original size; edge mode, as the JAX
    pipeline pads (a zero pad would differ over the receptive field).
    """
    n, h, w, c = x.shape
    hp = -(-h // multiple) * multiple
    wp = -(-w // multiple) * multiple
    if hp == h and wp == w:
        return x, (h, w)
    x = F.pad(x.permute(0, 3, 1, 2), (0, wp - w, 0, hp - h), mode="replicate")
    return x.permute(0, 2, 3, 1), (h, w)
