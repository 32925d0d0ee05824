"""Zero-border backward warp (counterpart of ``sstem_tpu/ops/warp.py``).

``spatial_transform`` reproduces the reference's ``SpatialTransformation``
module (``image_warp_torch.py:97-113``): the image is zero-padded by one
pixel, sample coordinates are shifted by +1, and the upper corner index is
clipped from the UNclipped base (``x1 = clip(floor(x) + 1)``), separately
from ``x0 = clip(floor(x))``. The weights use the clipped ``x1``, so they
leave [0, 1] far outside the image; the samples there are border zeros.
This is not ``grid_sample``'s convention.

It is written as four plain gathers. It is the CPU path of
``kernels/warp.py::serving_warp`` and the plain version that the CUDA warp
kernel is checked against.
"""

import torch
import torch.nn.functional as F


def spatial_transform(im, flow):
    """Backward-warp ``im`` by ``flow`` with a zero 1-px border.

    Args:
      im: (N, H, W, C) tensor.
      flow: (N, H, W, 2) tensor; channel 0 is dx, channel 1 is dy.

    Returns:
      (N, H, W, C) float32 tensor.
    """
    n, h, w, c = im.shape
    ph, pw = h + 2, w + 2
    gx = torch.arange(w, dtype=torch.float32, device=im.device)
    gy = torch.arange(h, dtype=torch.float32, device=im.device)[:, None]
    x = flow[..., 0].float() + gx + 1.0
    y = flow[..., 1].float() + gy + 1.0

    x0u = torch.floor(x).long()
    y0u = torch.floor(y).long()
    x1c = (x0u + 1).clamp(0, pw - 1)
    y1c = (y0u + 1).clamp(0, ph - 1)
    x0c = x0u.clamp(0, pw - 1)
    y0c = y0u.clamp(0, ph - 1)
    wx = (x1c.float() - x)[..., None]
    wy = (y1c.float() - y)[..., None]

    padded = F.pad(im.float().permute(0, 3, 1, 2), (1, 1, 1, 1))
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
