"""Replication padding and the loss crop (counterpart of
``sstem_tpu/ops/pad.py``: ``replication_pad_2d`` and ``negative_pad_2d``).

Reference behaviour: ``nn.ReplicationPad2d(K//2)`` on each source frame before
the separable convolution, and the SP trainers' ``F.pad(x, (-PAD,)*4)`` loss
crop. The port's models are NCHW, so both act on the two trailing dims; the
JAX functions act on the spatial dims of NHWC.
"""

import torch.nn.functional as F


def replication_pad_2d(x, pad: int):
    """Edge-replicate the two trailing (spatial) dims of an (N, C, H, W)
    tensor by ``pad`` on every side."""
    return F.pad(x, (pad, pad, pad, pad), mode="replicate")


def negative_pad_2d(x, pad: int):
    """Crop ``pad`` pixels from each border of the two trailing (spatial)
    dims of an (N, C, H, W) tensor (sp_scripts_train/main_interp.py:137-140,
    main_correction.py:144-149, main_fusion.py:228-233). ``pad == 0`` is the
    identity, as in torch."""
    if pad == 0:
        return x
    if pad < 0:
        raise ValueError("negative_pad_2d takes the crop amount (>= 0)")
    h, w = x.shape[-2], x.shape[-1]
    if 2 * pad >= h or 2 * pad >= w:
        raise ValueError(
            f"crop pad {pad} consumes the whole {h}x{w} patch (loss would be "
            "NaN); lower TRAIN PAD or raise patch_size")
    return x[..., pad:-pad, pad:-pad]
