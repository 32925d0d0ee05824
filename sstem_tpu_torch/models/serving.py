"""Fused-conv serving forwards (eval mode, bf16) of the three SFF nets
(counterpart of ``sstem_tpu/models/serving.py``: ``fusionnet_serve``,
``unet_sff_serve``, ``ifnet_serve`` with ``n_frames=1``,
``fold_gray_pair_conv`` and ``_with_folded_first_conv``).

Each forward takes the port's eval module (``FusionNet``, ``UNetSFF``,
``IFNet``) and reads its weights and BatchNorm buffers; activations are NHWC
bf16 throughout, as the JAX serving forwards' are. The split between kernels
and library ops is the JAX package's:

  * where the JAX forward calls a Pallas kernel, this one calls the port's
    CUDA kernel: ``conv3x3_fused`` (full- and half-resolution convs with
    eval BatchNorm, bias, residual and activation in the epilogue),
    ``pool2x`` (the first pool of each net), ``deconv2x_fused`` (the two
    finest transposed convs of FusionNet and UNetSFF) and, with
    ``fused_head_tail``, ``head_tail``;
  * where it stays on XLA, this one stays on cuDNN with the same rounding
    points: a bf16 conv plus a bf16 bias add (``_conv_eval``), BatchNorm's
    affine in float32 rounded to bf16 (``_bn_eval``), bf16 activations.
    Those convs run on channels-last views of the NHWC tensors, so no
    layout transposes are made between the two kinds of op.

Two-channel inputs ([gray, other] pairs) are taken directly: the first conv
of each net is pair-folded (``fold_gray_pair_conv``), which is exact on the
replicated-gray 6-channel input the modules take.

The weights each forward needs (HWIO bf16 kernels, folded float32 scales and
shifts, channels-last cuDNN weights) are prepared once per module and kept
until one of its parameters or buffers changes.
"""

import copy
import itertools
import weakref

import torch
import torch.nn.functional as F

from sstem_tpu_torch.kernels import (
    activate,
    conv3x3_fused,
    deconv2x_fused,
    fold_affine,
    head_tail,
    pool2x,
    sepconv_planar,
)
from sstem_tpu_torch.ops import replication_pad_2d

_BF = torch.bfloat16


# ---------------------------------------------------------------------------
# replicated-gray input folding
# ---------------------------------------------------------------------------

def fold_gray_pair_conv(conv):
    """A 6-channel first conv folded into 2 channels for replicated-gray
    inputs: the pipelines feed [gray x3, other x3], so conv(w6, x6) ==
    conv(w2, x2) with w2[:, 0] = sum(w6[:, 0:3]) and w2[:, 1] = sum(w6[:, 3:6])
    (exact in float32). Returns a new conv; ``conv`` is not changed."""
    w = conv.weight
    if w.shape[1] != 6:
        raise ValueError(f"fold_gray_pair_conv wants a 6-channel conv; got "
                         f"{tuple(w.shape)}")
    folded = copy.copy(conv)
    folded._parameters = dict(conv._parameters)
    folded.weight = torch.nn.Parameter(
        torch.stack([w[:, 0:3].sum(1), w[:, 3:6].sum(1)], 1).detach(),
        requires_grad=False)
    folded.in_channels = 2
    return folded


def _with_folded_first_conv(model, path):
    """A shallow copy of ``model`` with the conv at ``path`` (attribute
    names and Sequential indices) pair-folded; ``model`` is not changed."""
    root = copy.copy(model)
    root._modules = dict(model._modules)
    node = root
    for key in path[:-1]:
        child = copy.copy(node._modules[key])
        child._modules = dict(child._modules)
        node._modules[key] = child
        node = child
    node._modules[path[-1]] = fold_gray_pair_conv(node._modules[path[-1]])
    return root


# ---------------------------------------------------------------------------
# prepared weights
# ---------------------------------------------------------------------------

_PREPARED = weakref.WeakKeyDictionary()


def _stamp(model):
    """What the prepared weights depend on: each tensor's storage and
    version."""
    out = []
    for t in itertools.chain(model.parameters(), model.buffers()):
        try:
            version = t._version
        except RuntimeError:  # inference tensors keep no version counter
            version = None
        out.append((t.data_ptr(), version))
    return tuple(out)


def _prepared(model, key, build):
    """``build(model)``, cached per module and ``key`` until the module's
    parameters or buffers change."""
    stamp = _stamp(model)
    cache = _PREPARED.setdefault(model, {})
    hit = cache.get(key)
    if hit is None or hit[0] != stamp:
        with torch.no_grad():
            hit = (stamp, build(model))
        cache[key] = hit
    return hit[1]


def _bn_affine(bn):
    """Eval BatchNorm as y = x * scale + shift (float32)."""
    scale = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    shift = bn.bias.float() - bn.running_mean.float() * scale
    return scale, shift


def _kconv(conv, bn=None, cout_pad=None):
    """(w HWIO bf16, scale, shift) of conv [+ eval BN] for conv3x3_fused;
    cout_pad appends zero output channels."""
    w = conv.weight.float()
    b = conv.bias.float()
    s = t = None
    if bn is not None:
        s, t = _bn_affine(bn)
    if cout_pad is not None and cout_pad > w.shape[0]:
        extra = cout_pad - w.shape[0]
        w = F.pad(w, (0, 0, 0, 0, 0, 0, 0, extra))
        b = F.pad(b, (0, extra))
    scale, shift = fold_affine(w.shape[0], b, s, t)
    return w.permute(2, 3, 1, 0).to(_BF).contiguous(), scale, shift


def _kdeconv(deconv, bn):
    """(w (3, 3, Cin, Cout) bf16, scale, shift) of a ConvTranspose2d + eval
    BN for deconv2x_fused."""
    s, t = _bn_affine(bn)
    scale, shift = fold_affine(deconv.weight.shape[1], deconv.bias, s, t)
    return deconv.weight.permute(2, 3, 0, 1).to(_BF).contiguous(), scale, shift


def _xconv(conv):
    """(channels-last bf16 weight, bf16 bias) of a conv or transposed conv
    for cuDNN."""
    return (conv.weight.to(_BF).contiguous(memory_format=torch.channels_last),
            conv.bias.to(_BF))


def _split_conv(conv, bn, ca):
    """conv(concat(a, b)) + BN split by weight: (a's args, b's args), where
    a's conv carries the bias and b's the BN affine."""
    w = conv.weight.float()
    wa = w[:, :ca].permute(2, 3, 1, 0).to(_BF).contiguous()
    wb = w[:, ca:].permute(2, 3, 1, 0).to(_BF).contiguous()
    s, t = _bn_affine(bn)
    return ((wa, *fold_affine(w.shape[0], conv.bias.float())),
            (wb, *fold_affine(w.shape[0], None, s, t)))


# ---------------------------------------------------------------------------
# library ops, with the JAX forwards' rounding points (NHWC bf16)
# ---------------------------------------------------------------------------

def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1)


def _conv_eval(x, p):
    """Conv2dTorch eval: bf16 conv, then a bf16 bias add."""
    w, b = p
    return _nhwc(F.conv2d(_nchw(x), w, padding=1)) + b


def _bn_eval(x, st):
    s, t = st
    return (x.float() * s + t).to(_BF)


def _deconv_eval(x, p):
    """ConvTranspose2dTorch eval (k3 s2 p1 op1), then a bf16 bias add."""
    w, b = p
    y = F.conv_transpose2d(_nchw(x), w, stride=2, padding=1, output_padding=1)
    return _nhwc(y) + b


def _maxpool(x):
    return _nhwc(F.max_pool2d(_nchw(x), 2))


def _avgpool(x):
    """f32 window sum * 0.25, rounded to bf16."""
    return _nhwc(F.avg_pool2d(_nchw(x).float(), 2)).to(_BF)


def _upsample(x, out_hw):
    return _nhwc(F.interpolate(_nchw(x), size=out_hw, mode="bilinear",
                               align_corners=True))


# ---------------------------------------------------------------------------
# FusionNet
# ---------------------------------------------------------------------------

def _crc_parts(block):
    """The five (conv, bn) pairs of a ConvResidualConv in call order."""
    c2 = block.conv_2
    return [(block.conv_1[0], block.conv_1[1]), (c2[0][0], c2[0][1]),
            (c2[1][0], c2[1][1]), (c2[2], c2[3]),
            (block.conv_3[0], block.conv_3[1])]


def _fusionnet_args(model):
    kernel = ("down_1", "down_2", "up_3", "up_4")
    xla = ("down_3", "down_4", "bridge", "up_1", "up_2")
    p = {name: [_kconv(c, bn) for c, bn in _crc_parts(getattr(model, name))]
         for name in kernel}
    for name in xla:
        p[name] = [(_xconv(c), _bn_affine(bn))
                   for c, bn in _crc_parts(getattr(model, name))]
    for name in ("deconv_1", "deconv_2"):
        seq = getattr(model, name)
        p[name] = (_xconv(seq[0]), _bn_affine(seq[1]))
    for name in ("deconv_3", "deconv_4"):
        seq = getattr(model, name)
        p[name] = _kdeconv(seq[0], seq[1])
    p["out"] = _kconv(model.out)
    return p


def _crc_kernel(x, convs, act):
    """ConvResidualConv on the conv kernel; the residual add fuses into the
    conv_2 tail conv's epilogue (after its affine, before conv_3)."""
    c1 = conv3x3_fused(x, *convs[0], act)
    h = conv3x3_fused(c1, *convs[1], act)
    h = conv3x3_fused(h, *convs[2], act)
    h = conv3x3_fused(h, *convs[3], None, residual=c1)
    return conv3x3_fused(h, *convs[4], act)


def _crc_xla(x, parts, act):
    def cb(h, part, act=act):
        conv, bn = part
        return activate(_bn_eval(_conv_eval(h, conv), bn), act)
    c1 = cb(x, parts[0])
    h = cb(c1, parts[1])
    h = cb(h, parts[2])
    c2 = cb(h, parts[3], act=None)
    return cb(c1 + c2, parts[4])


def fusionnet_serve(model, x):
    """Eval FusionNet forward in bf16: levels 1 (full resolution) and 2 (half)
    and their decoder deconvs on the kernels, the rest on cuDNN.

    Args:
      model: the port's ``FusionNet`` (ngf 32).
      x: (N, H, W, 6) replicated-gray input or the (N, H, W, 2) gray pair, H
        and W multiples of 16.

    Returns:
      (N, H, W, output_nc) bfloat16.
    """
    if model.down_1.conv_1[0].out_channels != 32:
        raise ValueError("fusionnet_serve serves the reference ngf=32")
    fold = x.shape[-1] == 2
    p = _prepared(model, ("fusionnet", fold), lambda m: _fusionnet_args(
        _with_folded_first_conv(m, ("down_1", "conv_1", "0")) if fold else m))
    x = x.to(_BF).contiguous()
    d1 = _crc_kernel(x, p["down_1"], "leaky")
    d2 = _crc_kernel(pool2x(d1, "max"), p["down_2"], "leaky")
    down_3 = _crc_xla(_maxpool(d2), p["down_3"], "leaky")
    down_4 = _crc_xla(_maxpool(down_3), p["down_4"], "leaky")
    bridge = _crc_xla(_maxpool(down_4), p["bridge"], "leaky")

    def deconv_block(h, name):
        conv, bn = p[name]
        return torch.relu(_bn_eval(_deconv_eval(h, conv), bn))

    up_1 = _crc_xla((deconv_block(bridge, "deconv_1") + down_4) / 2,
                    p["up_1"], "relu")
    up_2 = _crc_xla((deconv_block(up_1, "deconv_2") + down_3) / 2,
                    p["up_2"], "relu")
    # (act(bn(deconv)) + skip) / 2 in the deconv kernel's epilogue
    u3 = deconv2x_fused(up_2.contiguous(), *p["deconv_3"], "relu",
                        residual=d2, res_mode="post_act_half")
    u3 = _crc_kernel(u3, p["up_3"], "relu")
    u4 = deconv2x_fused(u3, *p["deconv_4"], "relu", residual=d1,
                        res_mode="post_act_half")
    u4 = _crc_kernel(u4, p["up_4"], "relu")
    return conv3x3_fused(u4, *p["out"], None)


# ---------------------------------------------------------------------------
# UNetSFF
# ---------------------------------------------------------------------------

def _unet_sff_args(model):
    e1, e2, e3 = model.conv_encode1, model.conv_encode2, model.conv_encode3
    bt, d3, d2, fl = (model.bottleneck, model.conv_decode3,
                      model.conv_decode2, model.final_layer)
    return {
        "encode1": [_kconv(e1[0], e1[1]), _kconv(e1[3], e1[4])],
        "encode2": [_kconv(e2[0], e2[1]), _kconv(e2[3], e2[4])],
        "encode3": [(_xconv(e3[0]), _bn_affine(e3[1])),
                    (_xconv(e3[3]), _bn_affine(e3[4]))],
        "bottleneck": [(_xconv(bt[0]), _bn_affine(bt[1])),
                       (_xconv(bt[3]), _bn_affine(bt[4]))],
        "bottleneck_deconv": (_xconv(bt[6]), _bn_affine(bt[7])),
        "decode3": [(_xconv(d3[0]), _bn_affine(d3[1])),
                    (_xconv(d3[3]), _bn_affine(d3[4]))],
        "decode3_deconv": _kdeconv(d3[6], d3[7]),
        "decode2_split": _split_conv(d2[0], d2[1], d2[0].in_channels // 2),
        "decode2_conv1": _kconv(d2[3], d2[4]),
        "decode2_deconv": _kdeconv(d2[6], d2[7]),
        "final_split": _split_conv(fl[0], fl[1], fl[0].in_channels // 2),
        "final_conv1": _kconv(fl[3], fl[4]),
    }


def _split_concat_conv(a, b, split):
    """conv(concat(a, b)) + BN + ReLU via the weight split: a's conv (with
    the bias) joins b's accumulator before the affine."""
    (wa, sa, ta), (wb, sb, tb) = split
    ya = conv3x3_fused(a, wa, sa, ta, None)
    return conv3x3_fused(b, wb, sb, tb, "relu", residual=ya,
                         residual_pre_affine=True)


def unet_sff_serve(model, x):
    """Eval UNetSFF forward in bf16: encode1, encode2, the decode2 convs, the
    final layer and the two finest deconvs on the kernels, the rest on
    cuDNN.

    Args:
      model: the port's ``UNetSFF``.
      x: (N, H, W, 6) replicated-gray input or the (N, H, W, 2) gray pair, H
        and W multiples of 8.

    Returns:
      (N, H, W, out_channel) bfloat16.
    """
    fold = x.shape[-1] == 2
    p = _prepared(model, ("unet_sff", fold), lambda m: _unet_sff_args(
        _with_folded_first_conv(m, ("conv_encode1", "0")) if fold else m))
    x = x.to(_BF).contiguous()

    def cb_xla(h, part):
        conv, bn = part
        return torch.relu(_bn_eval(_conv_eval(h, conv), bn))

    e1 = conv3x3_fused(x, *p["encode1"][0], "relu")
    e1 = conv3x3_fused(e1, *p["encode1"][1], "relu")
    e2 = conv3x3_fused(pool2x(e1, "max"), *p["encode2"][0], "relu")
    e2 = conv3x3_fused(e2, *p["encode2"][1], "relu")
    e3 = cb_xla(cb_xla(_maxpool(e2), p["encode3"][0]), p["encode3"][1])
    b = cb_xla(cb_xla(_maxpool(e3), p["bottleneck"][0]), p["bottleneck"][1])
    conv, bn = p["bottleneck_deconv"]
    b = torch.relu(_bn_eval(_deconv_eval(b, conv), bn))
    c2 = cb_xla(torch.cat([b, e3], -1), p["decode3"][0])
    c2 = cb_xla(c2, p["decode3"][1])
    c2 = deconv2x_fused(c2.contiguous(), *p["decode3_deconv"], "relu")
    h = _split_concat_conv(c2, e2, p["decode2_split"])
    h = conv3x3_fused(h, *p["decode2_conv1"], "relu")
    c1 = deconv2x_fused(h, *p["decode2_deconv"], "relu")
    f = _split_concat_conv(c1, e1, p["final_split"])
    return conv3x3_fused(f, *p["final_conv1"], "relu")


# ---------------------------------------------------------------------------
# IFNet (SFF kernel-prediction net, one frame)
# ---------------------------------------------------------------------------

_HEADS = ("upconv51_1", "upconv51_2", "upconv51_3", "upconv51_4")


def _ifnet_args(model, fused_head_tail):
    def module(seq, conv=_kconv):
        return [conv(seq[i]) for i in (0, 2, 4)]

    def xla_module(seq):
        return [_xconv(seq[i]) for i in (0, 2, 4)]

    p = {"conv32": module(model.conv32), "conv64": module(model.conv64),
         "upsamp64": _kconv(model.upsamp64[1])}
    for name in ("conv128", "conv256", "conv512", "conv512x512", "upconv256",
                 "upconv128", "upconv64"):
        p[name] = xla_module(getattr(model, name))
    for name in ("upsamp512", "upsamp256", "upsamp128"):
        p[name] = _xconv(getattr(model, name)[1])
    for name in _HEADS:
        head = getattr(model, name)
        k = head[7].out_channels
        # the fused tail reads 64-channel features whose channels >= K are
        # exactly zero (zero weights and bias, relu(0) == 0), as the JAX
        # forward's full64 head does
        convs = [_kconv(head[0]), _kconv(head[2]),
                 _kconv(head[4], cout_pad=64 if fused_head_tail else None)]
        if fused_head_tail:
            tail = (head[7].weight.permute(2, 3, 1, 0).to(_BF).contiguous(),
                    head[7].bias.float().contiguous())
        else:
            tail = (head[7].weight.to(_BF).contiguous(), head[7].bias.to(_BF))
        p[name] = (convs, tail, k)
    return p


def ifnet_serve(model, x, n_frames=1, assume_gray=True,
                fused_head_tail=False):
    """Eval IFNet forward in bf16: the conv32 and conv64 modules, upsamp64's
    conv and the head convs 0-2 on the conv kernel, the first avg pool on
    the pool kernel, the levels below on cuDNN, then each head's tail
    (align-corners 2x upsample + conv3) and the two sepconvs.

    Args:
      model: the port's ``IFNet``.
      x: (N, H, W, 6) two replicated-gray frames, or the (N, H, W, 2) gray
        pair; H and W multiples of 32; values in 0..1.
      n_frames: 1 (the SFF net; the SP two-frame net is not ported yet).
      assume_gray: the frames are gray, so each sepconv runs on one channel.
      fused_head_tail: the head tails on the ``head_tail`` kernel instead of
        cuDNN's upsample and conv (the JAX ``SSTEM_FUSED_HEAD_TAIL=1``).

    Returns:
      (N, H, W, 1) float32.
    """
    if n_frames != 1:
        raise NotImplementedError("ifnet_serve serves the 1-frame SFF IFNet")
    if not assume_gray:
        raise NotImplementedError("ifnet_serve serves gray frames "
                                  "(assume_gray=True)")
    fold = x.shape[-1] == 2
    i1 = x[..., 0:1]
    i2 = x[..., 1:2] if fold else x[..., 3:4]
    p = _prepared(model, ("ifnet", fold, fused_head_tail), lambda m: _ifnet_args(
        _with_folded_first_conv(m, ("conv32", "0")) if fold else m,
        fused_head_tail))

    h = x.to(_BF).contiguous()
    for args in p["conv32"]:
        h = conv3x3_fused(h, *args, "relu")
    h = pool2x(h, "avg")
    for args in p["conv64"]:
        h = conv3x3_fused(h, *args, "relu")
    x64 = h

    def module_xla(t, convs):
        for conv in convs:
            t = torch.relu(_conv_eval(t, conv))
        return t

    def upsample_xla(t, conv, out_hw):
        return torch.relu(_conv_eval(_upsample(t, out_hw), conv))

    x128 = module_xla(_avgpool(x64), p["conv128"])
    x256 = module_xla(_avgpool(x128), p["conv256"])
    x512 = module_xla(_avgpool(x256), p["conv512"])
    xb = module_xla(_avgpool(x512), p["conv512x512"])
    xb = upsample_xla(xb, p["upsamp512"], x512.shape[1:3]) + x512
    xb = module_xla(xb, p["upconv256"])
    xb = upsample_xla(xb, p["upsamp256"], x256.shape[1:3]) + x256
    xb = module_xla(xb, p["upconv128"])
    xb = upsample_xla(xb, p["upsamp128"], x128.shape[1:3]) + x128
    xb = module_xla(xb, p["upconv64"])
    up = _upsample(xb, x64.shape[1:3]).contiguous()
    feat = conv3x3_fused(up, *p["upsamp64"], "relu") + x64

    def tail(name):
        convs, (w3, b3), k = p[name]
        t = feat
        for args in convs:
            t = conv3x3_fused(t, *args, "relu")
        if fused_head_tail:
            return head_tail(t, w3, b3)
        # cuDNN tail on planar maps: upsample, bf16 conv, bf16 bias add
        t = F.interpolate(_nchw(t).contiguous(), scale_factor=2,
                          mode="bilinear", align_corners=True)
        return F.conv2d(t, w3, padding=1) + b3[None, :, None, None]

    k2h, k2v, k1h, k1v = (tail(name) for name in _HEADS)
    pad = model.kernel_size // 2
    p1 = replication_pad_2d(_nchw(i1).float(), pad).to(_BF).contiguous()
    p2 = replication_pad_2d(_nchw(i2).float(), pad).to(_BF).contiguous()
    y = sepconv_planar(p2, k2v, k2h) + sepconv_planar(p1, k1v, k1h)
    return _nhwc(y).float()
