"""Fused 3x3 convolution with a per-channel affine, residual and activation
epilogue, NHWC bf16 (counterpart of ``sstem_tpu/kernels/conv3x3.py``:
``conv3x3_packed``, ``fold_affine``, ``conv3x3_reference``).

    y = act((conv3x3(x, w) [+ res if pre]) * scale + shift [+ res if post])

The conv is stride 1 with zero padding 1, summed in float32 over bf16 inputs
and weights; scale and shift are float32 per output channel (the conv bias
and eval BatchNorm, folded by ``fold_affine``); act is None, 'relu' or
'leaky' (slope 0.2); y is rounded once to bf16. The residual joins before
the affine (``residual_pre_affine``, the split concat conv) or after it (the
FusionNet residual block), always before the activation.

The JAX kernel's pixel packing (``pack_nhwc``, ``build_packed_weights``, the
zero-quad borders) fills the TPU's 128 lanes and is not ported: the port
takes plain NHWC tensors and HWIO weights with any channel count up to 128
(the JAX kernel's C in {8, ..., 128}; its 128 -> 64 convs pad the output to
128 and slice, the port's write 64 channels). CUDA tensors go through
``csrc/conv3x3_fused.cu``; CPU tensors through ``conv3x3_fused_plain``.

The CUDA kernel has two designs, which the C entry point picks by shape
(``design``), never as a fallback: the Hopper one (``wgmma`` on input tiles
staged by cp.async in a ring of shared-memory stages, coalesced epilogue)
where Cin is a multiple of 8 and Cout at least 16, which is every conv of
the packed paths at 32, 64 and 128 channels, and the ``mma.sync`` one of
the first port for the rest: the gray-pair first convs (Cin 1 or 2), odd
Cin such as K=51, and the narrow heads (Cout 1 or 2).
"""

import torch
import torch.nn.functional as F

from sstem_tpu_torch.kernels import _build

ACTS = {None: 0, "relu": 1, "leaky": 2}
MAX_CHANNELS = 128
# the wgmma design's shapes, as csrc/conv3x3_fused.cu picks them
WGMMA_CIN_MULTIPLE, WGMMA_MIN_COUT = 8, 16
# the C entry point of each design ("sstem_conv3x3_fused" picks by shape)
ENTRY_POINTS = {"wgmma": "sstem_conv3x3_fused",
                "mma": "sstem_conv3x3_fused_mma"}


def design(cin, cout):
    """The kernel design that serves a conv of cin -> cout channels:
    'wgmma' or 'mma' (the same rule as the C entry point's)."""
    if cin % WGMMA_CIN_MULTIPLE == 0 and cout >= WGMMA_MIN_COUT:
        return "wgmma"
    return "mma"


def fold_affine(cout, bias=None, bn_scale=None, bn_shift=None):
    """Conv bias and eval BatchNorm as per-channel float32 (scale, shift):
    scale = bn_scale (or 1), shift = bn_shift + bias * bn_scale."""
    ref = next((t for t in (bias, bn_scale, bn_shift) if t is not None), None)
    device = None if ref is None else ref.device
    s = (torch.ones(cout, device=device) if bn_scale is None
         else bn_scale.float())
    t = (torch.zeros(cout, device=device) if bn_shift is None
         else bn_shift.float())
    if bias is not None:
        t = t + bias.float() * s
    return s.contiguous(), t.contiguous()


def activate(y, act):
    """The epilogue's activation: None, 'relu' or 'leaky' (slope 0.2)."""
    if act == "relu":
        return torch.relu(y)
    if act == "leaky":
        return torch.where(y >= 0, y, 0.2 * y)
    return y


def conv3x3_fused_plain(x, w, scale, shift, act=None, residual=None,
                        residual_pre_affine=False):
    """Plain PyTorch version: a float32 conv of the bf16 values (TF32 off),
    the epilogue in float32, one rounding to bf16."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(x.float().permute(0, 3, 1, 2),
                     w.float().permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1)
    if residual is not None and residual_pre_affine:
        y = y + residual.float()
    y = y * scale + shift
    if residual is not None and not residual_pre_affine:
        y = y + residual.float()
    return activate(y, act).to(torch.bfloat16)


def _check(x, w, scale, shift, act, residual):
    if act not in ACTS:
        raise ValueError(f"conv3x3_fused: act must be one of {list(ACTS)}, "
                         f"got {act!r}")
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) or (
            w.shape[2] != x.shape[3]):
        raise ValueError(
            f"conv3x3_fused wants x (N,H,W,Cin) and w (3,3,Cin,Cout); got "
            f"{tuple(x.shape)}, {tuple(w.shape)}")
    cin, cout = w.shape[2:]
    if cin > MAX_CHANNELS or cout > MAX_CHANNELS:
        raise ValueError(f"conv3x3_fused takes at most {MAX_CHANNELS} "
                         f"channels in and out; got {cin}, {cout}")
    if tuple(scale.shape) != (cout,) or tuple(shift.shape) != (cout,):
        raise ValueError(f"conv3x3_fused: scale and shift must be ({cout},)")
    if residual is not None and tuple(residual.shape) != (*x.shape[:3], cout):
        raise ValueError(f"conv3x3_fused: residual must be "
                         f"{(*x.shape[:3], cout)}; got {tuple(residual.shape)}")
    bf16 = [x, w] + ([residual] if residual is not None else [])
    if any(t.dtype != torch.bfloat16 for t in bf16) or (
            scale.dtype != torch.float32 or shift.dtype != torch.float32):
        raise TypeError("conv3x3_fused takes bfloat16 x, w and residual and "
                        "float32 scale and shift")


def conv3x3_fused(x, w, scale, shift, act=None, residual=None,
                  residual_pre_affine=False):
    """Fused conv3x3 + affine [+ residual] + activation.

    Args:
      x: (N, H, W, Cin) bfloat16.
      w: (3, 3, Cin, Cout) bfloat16 (HWIO, the JAX kernel's layout), Cin and
        Cout at most 128.
      scale, shift: (Cout,) float32 (``fold_affine``).
      act: None, 'relu' or 'leaky'.
      residual: optional (N, H, W, Cout) bfloat16.
      residual_pre_affine: add the residual before the affine, not after.

    Returns:
      (N, H, W, Cout) bfloat16. ``conv3x3_fused.launches`` counts kernel
      launches.
    """
    _check(x, w, scale, shift, act, residual)
    tensors = [x, w, scale, shift] + ([residual] if residual is not None else [])
    if all(t.device.type == "cpu" for t in tensors):
        return conv3x3_fused_plain(x, w, scale, shift, act, residual,
                                   residual_pre_affine)
    _build.require_cuda("conv3x3_fused", *tensors)
    out = launch_entry("sstem_conv3x3_fused", x, w, scale, shift, act,
                       residual, residual_pre_affine)
    conv3x3_fused.launches += 1
    return out


conv3x3_fused.launches = 0


def launch_entry(entry, x, w, scale, shift, act=None, residual=None,
                 residual_pre_affine=False):
    """One launch of a C entry point (``ENTRY_POINTS``) on checked CUDA
    tensors, not counted in ``conv3x3_fused.launches``: ``conv3x3_fused``
    launches through it, and chip_smoke.py times each design with it."""
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    out = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    res_mode = 0 if residual is None else (1 if residual_pre_affine else 2)
    _build.launch(entry, x.get_device(), x.data_ptr(), w.data_ptr(),
                  scale.data_ptr(), shift.data_ptr(),
                  None if residual is None else residual.data_ptr(),
                  out.data_ptr(), n, h, wd, cin, cout, ACTS[act], res_mode)
    return out
