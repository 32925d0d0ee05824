"""Adaptive separable convolution, forward (counterpart of
``sstem_tpu/kernels/sepconv.py``: ``sepconv_planar`` and
``sepconv_reference_planar``).

    out[n, c, y, x] = sum_u V[n, u, y, x] * sum_v H[n, v, y, x] * im[n, c, y+u, x+v]

Planar layout, as the JAX function: image (N, C, H+K-1, W+K-1), already
replication-padded; maps (N, K, H, W). Accumulation is float32; the output
has the image's dtype.

``sepconv_planar`` launches the CUDA kernel ``csrc/sepconv_fwd.cu`` for CUDA
tensors and takes the plain version ``sepconv_planar_plain`` for CPU tensors.
This slice is eval only: there is no backward, and the wrapper refuses
inputs that require grad (the reference's backward, with its zero image
gradient, comes with training).
"""

import torch

from sstem_tpu_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)
MAX_TAPS = 51


def sepconv_planar_plain(image, vertical, horizontal):
    """Plain PyTorch sepconv: a loop over u with an inner loop over v on
    shifted slices, accumulated in float32, cast back to the image dtype."""
    out_dtype = image.dtype
    im = image.float()
    vert = vertical.float()
    horz = horizontal.float()
    n, c, hp, wp = im.shape
    k = vert.shape[1]
    ho, wo = hp - k + 1, wp - k + 1
    acc = torch.zeros((n, c, ho, wo), dtype=torch.float32, device=im.device)
    for u in range(k):
        hacc = torch.zeros_like(acc)
        for v in range(k):
            hacc.addcmul_(im[:, :, u:u + ho, v:v + wo], horz[:, v:v + 1])
        acc.addcmul_(vert[:, u:u + 1], hacc)
    return acc.to(out_dtype)


def _check(image, vertical, horizontal):
    tensors = (image, vertical, horizontal)
    if any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "sepconv_planar is forward-only in this port (eval under "
            "torch.inference_mode()); an input requires grad")
    if image.dim() != 4 or vertical.dim() != 4 or vertical.shape != horizontal.shape:
        raise ValueError(
            f"sepconv_planar wants image (N,C,Hp,Wp) and maps (N,K,H,W); got "
            f"{tuple(image.shape)}, {tuple(vertical.shape)}, "
            f"{tuple(horizontal.shape)}")
    n, c, hp, wp = image.shape
    k = vertical.shape[1]
    if vertical.shape[0] != n or (hp - k + 1, wp - k + 1) != tuple(vertical.shape[2:]):
        raise ValueError(
            f"sepconv_planar: image {tuple(image.shape)} is not the maps "
            f"{tuple(vertical.shape)} padded by K-1={k - 1}")
    if k > MAX_TAPS:
        raise ValueError(f"sepconv_planar takes K <= {MAX_TAPS}, got {k}")
    if image.dtype not in _DTYPES or vertical.dtype not in _DTYPES or (
            horizontal.dtype != vertical.dtype):
        raise TypeError(
            f"sepconv_planar takes float32 or bfloat16 (maps of one dtype); got "
            f"{image.dtype}, {vertical.dtype}, {horizontal.dtype}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("sepconv_planar: inputs on different devices")


def sepconv_planar(image, vertical, horizontal):
    """Adaptive separable convolution, planar layout.

    Args:
      image: (N, C, H+K-1, W+K-1) pre-padded source frames, f32 or bf16.
      vertical: (N, K, H, W) per-pixel vertical taps, f32 or bf16.
      horizontal: (N, K, H, W) per-pixel horizontal taps, same dtype.

    Returns:
      (N, C, H, W) in the image dtype. CUDA tensors go through the CUDA
      kernel (``sepconv_planar.launches`` counts its launches); CPU tensors
      through ``sepconv_planar_plain``.
    """
    _check(image, vertical, horizontal)
    if image.device.type == "cpu":
        return sepconv_planar_plain(image, vertical, horizontal)
    if image.device.type != "cuda":
        raise ValueError(f"sepconv_planar: unsupported device {image.device}")
    for name, t in (("image", image), ("vertical", vertical),
                    ("horizontal", horizontal)):
        if not t.is_contiguous():
            raise ValueError(f"sepconv_planar: {name} must be contiguous")
    n, c, hp, wp = image.shape
    k, h, w = vertical.shape[1:]
    lib = _build.library()
    out = torch.empty((n, c, h, w), dtype=image.dtype, device=image.device)
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sstem_sepconv_fwd(
            image.data_ptr(), vertical.data_ptr(), horizontal.data_ptr(),
            out.data_ptr(), n, c, h, w, k,
            int(image.dtype == torch.bfloat16),
            int(vertical.dtype == torch.bfloat16), stream)
    _build.check(rc, "sstem_sepconv_fwd")
    sepconv_planar.launches += 1
    return out


sepconv_planar.launches = 0
