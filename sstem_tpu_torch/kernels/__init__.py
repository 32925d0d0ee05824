from sstem_tpu_torch.kernels.conv3x3 import (
    activate,
    conv3x3_fused,
    conv3x3_fused_plain,
    fold_affine,
)
from sstem_tpu_torch.kernels.deconv import deconv2x_fused, deconv2x_fused_plain
from sstem_tpu_torch.kernels.head_tail import head_tail, head_tail_plain
from sstem_tpu_torch.kernels.pool import pool2x, pool2x_plain
from sstem_tpu_torch.kernels.sepconv import (
    sepconv_planar,
    sepconv_planar_bwd,
    sepconv_planar_bwd_plain,
    sepconv_planar_plain,
)
from sstem_tpu_torch.kernels.warp import serving_warp

__all__ = ["activate", "conv3x3_fused", "conv3x3_fused_plain",
           "deconv2x_fused", "deconv2x_fused_plain", "fold_affine",
           "head_tail", "head_tail_plain", "pool2x", "pool2x_plain",
           "sepconv_planar", "sepconv_planar_bwd", "sepconv_planar_bwd_plain",
           "sepconv_planar_plain", "serving_warp"]
