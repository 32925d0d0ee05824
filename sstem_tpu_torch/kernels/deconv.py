"""Fused 2x transposed convolution with an affine, activation and skip
epilogue, NHWC bf16 (counterpart of ``sstem_tpu/kernels/deconv.py``:
``deconv2x_packed``, ``deconv2x_reference``).

ConvTranspose2d(kernel 3, stride 2, padding 1, output_padding 1), exactly
2x, summed in float32 over bf16 inputs and weights, then

    post_affine:   y = act(acc * scale + shift + res)
    post_act_half: y = (act(acc * scale + shift) + res) / 2
    no residual:   y = act(acc * scale + shift)

rounded once to bf16. ``post_act_half`` is FusionNet's skip
``(deconv_block(x) + down) / 2``. Weights are PyTorch's ConvTranspose2d
weight (Cin, Cout, 3, 3) permuted to (3, 3, Cin, Cout); JAX's
(kh, kw, Cout, Cin) maps to it by swapping the last two axes. The JAX
kernel's pixel packing is not ported. CUDA tensors go through
``csrc/deconv2x_fused.cu``; CPU tensors through ``deconv2x_fused_plain``.

As for conv3x3, the C entry point picks one of two designs by shape
(``design``): the Hopper one (``wgmma`` on cp.async-staged tiles, all four
output parities of a tile computed before whole output rows are written)
where Cin is a multiple of 8 and Cout at least 16, which is both deconvs
of FusionNet and UNetSFF on the packed path (128 -> 64, 64 -> 32), and the
first port's ``mma.sync`` one for the rest.
"""

import torch
import torch.nn.functional as F

from sstem_tpu_torch.kernels import _build
from sstem_tpu_torch.kernels.conv3x3 import (
    ACTS, WGMMA_CIN_MULTIPLE, WGMMA_MIN_COUT, activate)

RES_MODES = {"post_affine": 1, "post_act_half": 2}
MAX_IN, MAX_OUT = 128, 64
# the C entry point of each design ("sstem_deconv2x_fused" picks by shape)
ENTRY_POINTS = {"wgmma": "sstem_deconv2x_fused",
                "mma": "sstem_deconv2x_fused_mma"}


def design(cin, cout):
    """The kernel design that serves a deconv of cin -> cout channels:
    'wgmma' or 'mma' (the same rule as the C entry point's)."""
    if cin % WGMMA_CIN_MULTIPLE == 0 and cout >= WGMMA_MIN_COUT:
        return "wgmma"
    return "mma"


def deconv2x_fused_plain(x, w, scale, shift, act=None, residual=None,
                         res_mode="post_affine"):
    """Plain PyTorch version: a float32 transposed conv of the bf16 values
    (TF32 off), the epilogue in float32, one rounding to bf16."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv_transpose2d(x.float().permute(0, 3, 1, 2),
                               w.float().permute(2, 3, 0, 1), stride=2,
                               padding=1, output_padding=1)
    y = y.permute(0, 2, 3, 1) * scale + shift
    if residual is not None and res_mode == "post_affine":
        y = y + residual.float()
    y = activate(y, act)
    if residual is not None and res_mode == "post_act_half":
        y = (y + residual.float()) * 0.5
    return y.to(torch.bfloat16)


def deconv2x_fused(x, w, scale, shift, act=None, residual=None,
                   res_mode="post_affine"):
    """Fused 2x ConvTranspose2d + affine + activation [+ skip].

    Args:
      x: (N, H, W, Cin) bfloat16, Cin at most 128.
      w: (3, 3, Cin, Cout) bfloat16, Cout at most 64.
      scale, shift: (Cout,) float32 (``conv3x3.fold_affine``).
      act: None, 'relu' or 'leaky'.
      residual: optional (N, 2H, 2W, Cout) bfloat16.
      res_mode: 'post_affine' or 'post_act_half'.

    Returns:
      (N, 2H, 2W, Cout) bfloat16. ``deconv2x_fused.launches`` counts kernel
      launches.
    """
    if act not in ACTS or res_mode not in RES_MODES:
        raise ValueError(f"deconv2x_fused: act must be one of {list(ACTS)} "
                         f"and res_mode one of {list(RES_MODES)}; got "
                         f"{act!r}, {res_mode!r}")
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) or (
            w.shape[2] != x.shape[3]):
        raise ValueError(
            f"deconv2x_fused wants x (N,H,W,Cin) and w (3,3,Cin,Cout); got "
            f"{tuple(x.shape)}, {tuple(w.shape)}")
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    if cin > MAX_IN or cout > MAX_OUT:
        raise ValueError(f"deconv2x_fused takes at most {MAX_IN} channels in "
                         f"and {MAX_OUT} out; got {cin}, {cout}")
    if tuple(scale.shape) != (cout,) or tuple(shift.shape) != (cout,):
        raise ValueError(f"deconv2x_fused: scale and shift must be ({cout},)")
    out_shape = (n, 2 * h, 2 * wd, cout)
    if residual is not None and tuple(residual.shape) != out_shape:
        raise ValueError(f"deconv2x_fused: residual must be {out_shape}; got "
                         f"{tuple(residual.shape)}")
    bf16 = [x, w] + ([residual] if residual is not None else [])
    if any(t.dtype != torch.bfloat16 for t in bf16) or (
            scale.dtype != torch.float32 or shift.dtype != torch.float32):
        raise TypeError("deconv2x_fused takes bfloat16 x, w and residual and "
                        "float32 scale and shift")
    tensors = [x, w, scale, shift] + ([residual] if residual is not None else [])
    if all(t.device.type == "cpu" for t in tensors):
        return deconv2x_fused_plain(x, w, scale, shift, act, residual,
                                    res_mode)
    _build.require_cuda("deconv2x_fused", *tensors)
    out = launch_entry("sstem_deconv2x_fused", x, w, scale, shift, act,
                       residual, res_mode)
    deconv2x_fused.launches += 1
    return out


deconv2x_fused.launches = 0


def launch_entry(entry, x, w, scale, shift, act=None, residual=None,
                 res_mode="post_affine"):
    """One launch of a C entry point (``ENTRY_POINTS``) on checked CUDA
    tensors, not counted in ``deconv2x_fused.launches``: ``deconv2x_fused``
    launches through it, and chip_smoke.py times each design with it."""
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    out = torch.empty((n, 2 * h, 2 * wd, cout), dtype=x.dtype,
                      device=x.device)
    mode = 0 if residual is None else RES_MODES[res_mode]
    _build.launch(entry, x.get_device(), x.data_ptr(), w.data_ptr(),
                  scale.data_ptr(), shift.data_ptr(),
                  None if residual is None else residual.data_ptr(),
                  out.data_ptr(), n, h, wd, cin, cout, ACTS[act], mode)
    return out
