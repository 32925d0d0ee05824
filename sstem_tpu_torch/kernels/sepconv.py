"""Adaptive separable convolution, forward and backward (counterpart of
``sstem_tpu/kernels/sepconv.py``: ``sepconv_planar`` with its custom VJP,
``sepconv_reference_planar`` and ``_bwd_xla_planar``).

    out[n, c, y, x] = sum_u V[n, u, y, x] * sum_v H[n, v, y, x] * im[n, c, y+u, x+v]

Planar layout, as the JAX function: image (N, C, H+K-1, W+K-1), already
replication-padded; maps (N, K, H, W). Accumulation is float32; the output
has the image's dtype.

The gradient is the reference op's: dV and dH, in the maps' dtype, and an
image gradient that is exactly zero (the reference CUDA op allocates it and
never writes it; the JAX package keeps that contract so training dynamics
match):

    s(u,v) = sum_c g * im[y+u, x+v];  dV[u] = sum_v H[v] s(u,v);  dH[v] = sum_u V[u] s(u,v)

CUDA tensors go through the kernels ``csrc/sepconv_fwd.cu`` and
``csrc/sepconv_bwd.cu``; CPU tensors through the plain versions
``sepconv_planar_plain`` and ``sepconv_planar_bwd_plain``. The plain versions
also take float64 (CPU only), which ``torch.autograd.gradcheck`` needs.

The forward kernel has two designs, which the C entry point picks by shape
(``design``), never as a fallback: the Hopper one (``blocked``: four pixels
a thread along x, their taps in registers, V staged by cp.async) where W is
a multiple of 4 and the maps are 16-byte aligned, which is every path's
shape, and the first port's one-pixel-a-thread design (``simple``) for the
rest.
"""

import torch
from torch.autograd.function import once_differentiable

from sstem_tpu_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)
MAX_TAPS = 51
# the blocked design's pixels a thread along x, as csrc/sepconv_fwd.cu
# picks it: W a multiple of it
BLOCKED_PIXELS = 4
# the C entry point of each forward design ("sstem_sepconv_fwd" picks)
ENTRY_POINTS = {"blocked": "sstem_sepconv_fwd",
                "simple": "sstem_sepconv_fwd_simple"}


def design(w):
    """The forward kernel design that serves an output width ``w``:
    'blocked' or 'simple', the C entry point's rule for maps and output on
    16-byte boundaries, as fresh allocations are (it takes the simple
    design for maps that are not)."""
    return "blocked" if w % BLOCKED_PIXELS == 0 else "simple"


def _acc_dtype(t):
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def sepconv_planar_plain(image, vertical, horizontal):
    """Plain PyTorch sepconv: a loop over u with an inner loop over v on
    shifted slices, accumulated in float32, cast back to the image dtype."""
    acc_dtype = _acc_dtype(image)
    im = image.to(acc_dtype)
    vert = vertical.to(acc_dtype)
    horz = horizontal.to(acc_dtype)
    n, c, hp, wp = im.shape
    k = vert.shape[1]
    ho, wo = hp - k + 1, wp - k + 1
    acc = torch.zeros((n, c, ho, wo), dtype=acc_dtype, device=im.device)
    for u in range(k):
        hacc = torch.zeros_like(acc)
        for v in range(k):
            hacc.addcmul_(im[:, :, u:u + ho, v:v + wo], horz[:, v:v + 1])
        acc.addcmul_(vert[:, u:u + 1], hacc)
    return acc.to(image.dtype)


def sepconv_planar_bwd_plain(image, vertical, horizontal, grad):
    """Plain PyTorch backward (the JAX oracle ``_bwd_xla_planar``'s loop):
    s(u,v) formed on shifted slices, dV and dH accumulated in float32 and
    rounded once to the maps' dtype."""
    acc_dtype = _acc_dtype(vertical)
    im = image.to(acc_dtype)
    vert = vertical.to(acc_dtype)
    horz = horizontal.to(acc_dtype)
    g = grad.to(acc_dtype)
    hp, wp = im.shape[2:]
    k = vert.shape[1]
    ho, wo = hp - k + 1, wp - k + 1
    dv = torch.zeros_like(vert)
    dh = torch.zeros_like(horz)
    for u in range(k):
        for v in range(k):
            s = (g * im[:, :, u:u + ho, v:v + wo]).sum(1)
            dv[:, u].addcmul_(horz[:, v], s)
            dh[:, v].addcmul_(vert[:, u], s)
    return dv.to(vertical.dtype), dh.to(horizontal.dtype)


def _check(image, vertical, horizontal):
    tensors = (image, vertical, horizontal)
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
    if len({t.device for t in tensors}) != 1:
        raise ValueError("sepconv_planar: inputs on different devices")
    dtypes = _DTYPES
    if image.device.type == "cpu" and image.dtype == vertical.dtype == torch.float64:
        dtypes = (torch.float64,)
    if image.dtype not in dtypes or vertical.dtype not in dtypes or (
            horizontal.dtype != vertical.dtype):
        raise TypeError(
            f"sepconv_planar takes float32 or bfloat16 (maps of one dtype; "
            f"float64 throughout on the CPU); got {image.dtype}, "
            f"{vertical.dtype}, {horizontal.dtype}")
    if image.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sepconv_planar: unsupported device {image.device}")
    if image.device.type == "cuda":
        for name, t in (("image", image), ("vertical", vertical),
                        ("horizontal", horizontal)):
            if not t.is_contiguous():
                raise ValueError(f"sepconv_planar: {name} must be contiguous")


def _sepconv_fwd(image, vertical, horizontal):
    if image.device.type == "cpu":
        return sepconv_planar_plain(image, vertical, horizontal)
    out = launch_entry("sstem_sepconv_fwd", image, vertical, horizontal)
    sepconv_planar.launches += 1
    return out


def launch_entry(entry, image, vertical, horizontal):
    """One launch of a forward C entry point (``ENTRY_POINTS``) on checked
    CUDA tensors, not counted in ``sepconv_planar.launches``: the forward
    launches through it, and chip_smoke.py times each design with it."""
    n, c = image.shape[:2]
    k, h, w = vertical.shape[1:]
    lib = _build.library()
    out = torch.empty((n, c, h, w), dtype=image.dtype, device=image.device)
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(
            image.data_ptr(), vertical.data_ptr(), horizontal.data_ptr(),
            out.data_ptr(), n, c, h, w, k,
            int(image.dtype == torch.bfloat16),
            int(vertical.dtype == torch.bfloat16), stream)
    _build.check(rc, entry)
    return out


def sepconv_planar_bwd(image, vertical, horizontal, grad):
    """dV and dH of ``sepconv_planar`` for the output gradient ``grad``.

    Args:
      image, vertical, horizontal: the forward's inputs.
      grad: (N, C, H, W) gradient of the output, in the image dtype.

    Returns:
      (dV, dH), each (N, K, H, W) in the maps' dtype. CUDA tensors go through
      the CUDA kernel (``sepconv_planar_bwd.launches`` counts its launches);
      CPU tensors through ``sepconv_planar_bwd_plain``.
    """
    _check(image, vertical, horizontal)
    n, c = image.shape[:2]
    if tuple(grad.shape) != (n, c, *vertical.shape[2:]) or (
            grad.dtype != image.dtype) or grad.device != image.device:
        raise ValueError(
            f"sepconv_planar_bwd: grad must be {(n, c, *vertical.shape[2:])} "
            f"{image.dtype} on {image.device}; got {tuple(grad.shape)} "
            f"{grad.dtype} on {grad.device}")
    if image.device.type == "cpu":
        return sepconv_planar_bwd_plain(image, vertical, horizontal, grad)
    if not grad.is_contiguous():
        raise ValueError("sepconv_planar_bwd: grad must be contiguous")
    k, h, w = vertical.shape[1:]
    lib = _build.library()
    dv = torch.empty_like(vertical)
    dh = torch.empty_like(horizontal)
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sstem_sepconv_bwd(
            image.data_ptr(), vertical.data_ptr(), horizontal.data_ptr(),
            grad.data_ptr(), dv.data_ptr(), dh.data_ptr(), n, c, h, w, k,
            int(image.dtype == torch.bfloat16),
            int(vertical.dtype == torch.bfloat16), stream)
    _build.check(rc, "sstem_sepconv_bwd")
    sepconv_planar_bwd.launches += 1
    return dv, dh


sepconv_planar_bwd.launches = 0


class _SepconvPlanar(torch.autograd.Function):
    @staticmethod
    def forward(ctx, image, vertical, horizontal):
        ctx.save_for_backward(image, vertical, horizontal)
        return _sepconv_fwd(image, vertical, horizontal)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        image, vertical, horizontal = ctx.saved_tensors
        dv = dh = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dv, dh = sepconv_planar_bwd(image, vertical, horizontal,
                                        grad.contiguous())
        dimage = torch.zeros_like(image) if ctx.needs_input_grad[0] else None
        return dimage, dv, dh


def sepconv_planar(image, vertical, horizontal):
    """Adaptive separable convolution, planar layout, differentiable.

    Args:
      image: (N, C, H+K-1, W+K-1) pre-padded source frames, f32 or bf16.
      vertical: (N, K, H, W) per-pixel vertical taps, f32 or bf16.
      horizontal: (N, K, H, W) per-pixel horizontal taps, same dtype.

    Returns:
      (N, C, H, W) in the image dtype. CUDA tensors go through the CUDA
      kernel (``sepconv_planar.launches`` counts its launches); CPU tensors
      through ``sepconv_planar_plain``. Backward gives dV and dH through
      ``sepconv_planar_bwd`` and an image gradient of exactly zero.
    """
    _check(image, vertical, horizontal)
    return _SepconvPlanar.apply(image, vertical, horizontal)


sepconv_planar.launches = 0
