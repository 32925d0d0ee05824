"""Bilinear upsampling with ``align_corners=True`` (counterpart of
``sstem_tpu/ops/resize.py``).

The reference's own op is ``nn.Upsample(scale_factor=2, mode='bilinear',
align_corners=True)``; PyTorch has it, so the port uses it on NCHW tensors.
"""

import torch.nn.functional as F


def upsample_bilinear_align_corners(x, scale_factor: int = 2):
    """(N, C, H, W) -> (N, C, s*H, s*W), bilinear with align_corners=True."""
    return F.interpolate(x, scale_factor=scale_factor, mode="bilinear",
                         align_corners=True)
