from sstem_tpu_torch.kernels.sepconv import sepconv_planar, sepconv_planar_plain
from sstem_tpu_torch.kernels.warp import serving_warp

__all__ = ["sepconv_planar", "sepconv_planar_plain", "serving_warp"]
