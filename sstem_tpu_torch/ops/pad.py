"""Replication padding (counterpart of ``sstem_tpu/ops/pad.py``).

Reference behaviour: ``nn.ReplicationPad2d(K//2)`` on each source frame before
the separable convolution. The port's models are NCHW, so this pads the two
trailing dims; the JAX function pads the spatial dims of NHWC.
"""

import torch.nn.functional as F


def replication_pad_2d(x, pad: int):
    """Edge-replicate the two trailing (spatial) dims of an (N, C, H, W)
    tensor by ``pad`` on every side."""
    return F.pad(x, (pad, pad, pad, pad), mode="replicate")
