"""Backward warps (counterpart of ``sstem_tpu/ops/warp.py``: ``image_warp``
and ``spatial_transform``). The two are different functions, and neither is
``grid_sample``'s convention.

``image_warp`` is the edge-clamped warp of the simulators and the fold
synthesis (``simu_sff/image_warp.py:3-112``): the base index
``clip(x + floor(dx))`` is clamped to the image, and the +1 neighbour is taken
from the *clamped* base (``min(x0c + 1, W - 1)``), so a coordinate below 0
samples pixels 0 and 1. The weights are the unclamped fractional parts.

``spatial_transform`` reproduces the reference's ``SpatialTransformation``
module (``image_warp_torch.py:97-113``): the image is zero-padded by one
pixel, sample coordinates are shifted by +1, and the upper corner index is
clipped from the UNclipped base (``x1 = clip(floor(x) + 1)``), separately
from ``x0 = clip(floor(x))``. The weights use the clipped ``x1``, so they
leave [0, 1] far outside the image; the samples there are border zeros.
This is not ``grid_sample``'s convention.

Both are written as four plain gathers (the JAX package's corner-packed
table is a TPU workaround and is not ported). ``spatial_transform`` is the
CPU path of ``kernels/warp.py::serving_warp`` and the plain version that the
CUDA warp kernel is checked against.
"""

import torch
import torch.nn.functional as F


def _gather(im, yy, xx):
    """im (N, H, W, C) at integer (N, H', W') row and column indices ->
    (N, H', W', C)."""
    n, h, w, c = im.shape
    flat = im.reshape(n, h * w, c)
    idx = (yy * w + xx).reshape(n, -1, 1).expand(-1, -1, c)
    return flat.gather(1, idx).reshape(*yy.shape, c)


def image_warp(im, flow, mode: str = "bilinear"):
    """Backward-warp ``im`` by ``flow`` with edge-clamped sampling.

    Args:
      im: (N, H, W, C) tensor (any dtype; computed in float32).
      flow: (N, H, W, 2) tensor; channel 0 is dx, channel 1 is dy.
      mode: 'bilinear' or 'nearest'.

    Returns:
      (N, H, W, C) float32. Truncate at the call site for the reference's
      ``astype(uint8)`` result.
    """
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unknown mode {mode!r}")
    n, h, w, c = im.shape
    im = im.float()
    fx = flow[..., 0].float()
    fy = flow[..., 1].float()
    gx = torch.arange(w, dtype=torch.float32, device=im.device)
    gy = torch.arange(h, dtype=torch.float32, device=im.device)[:, None]
    x0f = torch.floor(fx)
    y0f = torch.floor(fy)
    x0 = (gx + x0f).long().clamp(0, w - 1)
    y0 = (gy + y0f).long().clamp(0, h - 1)
    if mode == "nearest":
        return _gather(im, y0, x0)
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    xw = (fx - x0f)[..., None]
    yw = (fy - y0f)[..., None]
    return ((1 - xw) * (1 - yw) * _gather(im, y0, x0)
            + (1 - xw) * yw * _gather(im, y1, x0)
            + xw * (1 - yw) * _gather(im, y0, x1)
            + xw * yw * _gather(im, y1, x1))


def spatial_transform(im, flow):
    """Backward-warp ``im`` by ``flow`` with a zero 1-px border.

    Args:
      im: (N, H, W, C) tensor.
      flow: (N, H, W, 2) tensor; channel 0 is dx, channel 1 is dy.

    Returns:
      (N, H, W, C) float32 tensor (float64 for a float64 image, as the
      training-parity tests run it).
    """
    n, h, w, c = im.shape
    ph, pw = h + 2, w + 2
    dt = torch.promote_types(im.dtype, torch.float32)
    gx = torch.arange(w, dtype=dt, device=im.device)
    gy = torch.arange(h, dtype=dt, device=im.device)[:, None]
    x = flow[..., 0].to(dt) + gx + 1.0
    y = flow[..., 1].to(dt) + gy + 1.0

    x0u = torch.floor(x).long()
    y0u = torch.floor(y).long()
    x1c = (x0u + 1).clamp(0, pw - 1)
    y1c = (y0u + 1).clamp(0, ph - 1)
    x0c = x0u.clamp(0, pw - 1)
    y0c = y0u.clamp(0, ph - 1)
    wx = (x1c.to(dt) - x)[..., None]
    wy = (y1c.to(dt) - y)[..., None]

    padded = F.pad(im.to(dt).permute(0, 3, 1, 2), (1, 1, 1, 1))
    flat = padded.reshape(n, c, ph * pw)

    def sample(yy, xx):
        idx = (yy * pw + xx).reshape(n, 1, h * w).expand(n, c, h * w)
        return flat.gather(2, idx).reshape(n, c, h, w).permute(0, 2, 3, 1)

    ia = sample(y0c, x0c)
    ib = sample(y1c, x0c)
    ic = sample(y0c, x1c)
    id_ = sample(y1c, x1c)
    return (wx * wy * ia + wx * (1 - wy) * ib
            + (1 - wx) * wy * ic + (1 - wx) * (1 - wy) * id_)
