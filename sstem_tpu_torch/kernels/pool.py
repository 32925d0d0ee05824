"""2x2 stride-2 pooling on NHWC bf16 (counterpart of
``sstem_tpu/kernels/pool.py``: ``pool2x_packed``).

Max is exact; average sums the window in float32 in the JAX kernel's order,
``((x00 + x01) + x10) + x11``, scales by 0.25 and rounds once to bf16. The
JAX kernel's pixel packing (its output lands in the next level's 128-lane
layout) is a TPU layout and is not ported: the port pools plain NHWC
tensors. CUDA tensors go through ``csrc/pool2x.cu``; CPU tensors through
``pool2x_plain``.
"""

import torch

from sstem_tpu_torch.kernels import _build

_MODES = {"avg": 0, "max": 1}


def pool2x_plain(x, mode="max"):
    """Plain PyTorch 2x2 pool of (N, H, W, C): float32 arithmetic on the
    input values, rounded once to the input dtype; an odd last row or column
    is dropped."""
    ho, wo = x.shape[1] // 2, x.shape[2] // 2
    xf = x[:, :2 * ho, :2 * wo].float()
    a, b = xf[:, 0::2, 0::2], xf[:, 0::2, 1::2]
    c, d = xf[:, 1::2, 0::2], xf[:, 1::2, 1::2]
    if mode == "max":
        y = torch.maximum(torch.maximum(a, b), torch.maximum(c, d))
    else:
        y = (a + b + c + d) * 0.25
    return y.to(x.dtype)


def pool2x(x, mode="max"):
    """2x2 stride-2 max or average pool.

    Args:
      x: (N, H, W, C) bfloat16, H and W >= 2.
      mode: 'max' or 'avg'.

    Returns:
      (N, H // 2, W // 2, C) bfloat16. ``pool2x.launches`` counts kernel
      launches.
    """
    if mode not in _MODES:
        raise ValueError(f"pool2x: mode must be 'max' or 'avg', got {mode!r}")
    if x.dim() != 4 or x.shape[1] < 2 or x.shape[2] < 2:
        raise ValueError(f"pool2x wants (N, H, W, C) with H, W >= 2; got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"pool2x takes bfloat16; got {x.dtype}")
    if x.device.type == "cpu":
        return pool2x_plain(x, mode)
    device = _build.require_cuda("pool2x", x)
    n, h, w, c = x.shape
    out = torch.empty((n, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    _build.launch("sstem_pool2x", device, x.data_ptr(), out.data_ptr(), n, h,
                  w, c, _MODES[mode])
    pool2x.launches += 1
    return out


pool2x.launches = 0
