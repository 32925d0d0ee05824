"""Fused align-corners 2x upsample + 3x3 conv + bias, the IFNet kernel heads'
tail (counterpart of ``sstem_tpu/kernels/head_tail.py``: ``head_tail_fused``
with ``dephase_transpose``, and its oracle ``head_tail_oracle``).

    up  = bf16(upsample2x_align_corners(x[..., :cin]))
    out = bf16(conv3x3(up, w3) + b3)

The upsample is PyTorch's bilinear ``align_corners=True`` in float32,
rounded once to bf16 before the conv, where the JAX kernel rounds its staged
rows; the conv sums in float32 and adds a float32 bias. The output is the
sepconv's planar (N, K, 2Hi, 2Wi) layout. The JAX kernel's phase split and
phase-planar output (and its ``(w // 2) % 128 == 0`` eligibility test) are
TPU layouts and are not ported: any half-resolution size is taken. CUDA
tensors go through ``csrc/head_tail.cu``; CPU tensors through
``head_tail_plain``.
"""

import torch
import torch.nn.functional as F

from sstem_tpu_torch.kernels import _build

MAX_CHANNELS = 64


def head_tail_plain(x, w3, b3):
    """Plain PyTorch version: ``F.interpolate`` in float32, one rounding to
    bf16, a float32 conv of those values (TF32 off) plus the bias, one
    rounding to bf16."""
    cin = w3.shape[2]
    up = F.interpolate(x[..., :cin].permute(0, 3, 1, 2).float(),
                       scale_factor=2, mode="bilinear", align_corners=True)
    up = up.to(torch.bfloat16).float()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(up, w3.float().permute(3, 2, 0, 1), padding=1)
    return (y + b3.float()[None, :, None, None]).to(torch.bfloat16)


def head_tail(x, w3, b3):
    """Upsample 2x (align corners) and conv3x3 + bias, planar output.

    Args:
      x: (N, Hi, Wi, Cx) bfloat16 half-resolution features; the conv reads
        the first Cin channels (Cin <= Cx <= 64), the rest are ignored.
      w3: (3, 3, Cin, K) bfloat16 (HWIO), K at most 64.
      b3: (K,) float32.

    Returns:
      (N, K, 2Hi, 2Wi) bfloat16 tap maps. ``head_tail.launches`` counts
      kernel launches.
    """
    if x.dim() != 4 or w3.dim() != 4 or tuple(w3.shape[:2]) != (3, 3):
        raise ValueError(f"head_tail wants x (N,Hi,Wi,Cx) and w3 (3,3,Cin,K); "
                         f"got {tuple(x.shape)}, {tuple(w3.shape)}")
    n, hi, wi, cx = x.shape
    cin, k = w3.shape[2:]
    if not cin <= cx <= MAX_CHANNELS or k > MAX_CHANNELS:
        raise ValueError(f"head_tail needs Cin <= Cx <= {MAX_CHANNELS} and "
                         f"K <= {MAX_CHANNELS}; got Cin={cin}, Cx={cx}, K={k}")
    if tuple(b3.shape) != (k,):
        raise ValueError(f"head_tail: b3 must be ({k},); got {tuple(b3.shape)}")
    if x.dtype != torch.bfloat16 or w3.dtype != torch.bfloat16 or (
            b3.dtype != torch.float32):
        raise TypeError("head_tail takes bfloat16 x and w3 and a float32 b3")
    if all(t.device.type == "cpu" for t in (x, w3, b3)):
        return head_tail_plain(x, w3, b3)
    _build.require_cuda("head_tail", x, w3, b3)
    out = torch.empty((n, k, 2 * hi, 2 * wi), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.sstem_head_tail(x.data_ptr(), w3.data_ptr(), b3.data_ptr(),
                                 out.data_ptr(), n, hi, wi, cx, cin, k,
                                 _build.stream())
    _build.check(rc, "sstem_head_tail")
    head_tail.launches += 1
    return out


head_tail.launches = 0
