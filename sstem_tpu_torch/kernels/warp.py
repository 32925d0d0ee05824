"""The serving warp (counterpart of ``sstem_tpu/kernels/warp_band.py``:
``serving_warp``).

Same function as ``ops/warp.py::spatial_transform`` on the serving layout: a
single-channel NHWC image and an NHWC flow with channel 0 = dx. CUDA tensors
go through ``csrc/warp_bilinear.cu``, one thread per pixel, exact for every
flow and every H; CPU tensors through ``spatial_transform``, which is also
the plain version the kernel is checked against.
"""

import torch

from sstem_tpu_torch.kernels import _build
from sstem_tpu_torch.ops.warp import spatial_transform


def serving_warp(im, flow):
    """Zero-border bilinear backward warp.

    Args:
      im: (N, H, W, 1) float32.
      flow: (N, H, W, 2) float32; channel 0 dx, channel 1 dy.

    Returns:
      (N, H, W, 1) float32. ``serving_warp.launches`` counts kernel launches.
    """
    if im.dim() != 4 or im.shape[-1] != 1 or tuple(flow.shape) != (
            *im.shape[:3], 2):
        raise ValueError(
            f"serving_warp wants im (N,H,W,1) and flow (N,H,W,2); got "
            f"{tuple(im.shape)}, {tuple(flow.shape)}")
    if im.dtype != torch.float32 or flow.dtype != torch.float32:
        raise TypeError(
            f"serving_warp takes float32; got {im.dtype}, {flow.dtype}")
    if im.device != flow.device:
        raise ValueError("serving_warp: im and flow on different devices")
    if im.device.type == "cpu":
        return spatial_transform(im, flow)
    if im.device.type != "cuda":
        raise ValueError(f"serving_warp: unsupported device {im.device}")
    if not (im.is_contiguous() and flow.is_contiguous()):
        raise ValueError("serving_warp: im and flow must be contiguous")
    n, h, w, _ = im.shape
    out = torch.empty_like(im)
    _build.launch("sstem_warp_bilinear", im.get_device(), im.data_ptr(),
                  flow.data_ptr(), out.data_ptr(), n, h, w)
    serving_warp.launches += 1
    return out


serving_warp.launches = 0
