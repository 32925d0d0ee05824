"""Layers and initializers (counterpart of ``sstem_tpu/models/layers.py``).

Conv2d(k3 s1 p1), ConvTranspose2d(k3 s2 p1 op1) and BatchNorm2d are PyTorch's
own; BatchNorm2d's running variance is already the unbiased one. The
subclasses here only add the numerical policies of ``config.py``. A conv
runs in its weight's dtype and casts its input on entry, except with
float32 weights:

  * under the bf16 compute dtype (``config.set_compute_dtype``) it casts
    input, weight and bias to bf16 and returns bf16, as JAX's
    ``Conv2dTorch`` and ``ConvTranspose2dTorch`` cast to
    ``compute_dtype()``; the casts sit inside autograd, so the gradients
    reach the float32 parameters in float32. A conv marked by
    ``float32_activations`` (VGG19, the discriminators: plain flax convs in
    the JAX package) keeps float32;
  * else, under the ``"default"`` matmul precision, it runs one bf16 pass
    (input and weight cast to bf16, the result back to float32, the bias
    added in float32: JAX's ``Precision.DEFAULT``).

BatchNorm normalises in its parameters' dtype (float32; float64 for a model
cast whole, as the training-parity tests run it) and emits its input's
dtype: under the bf16 compute dtype, statistics in float32, running
statistics float32, output bf16.

Layers are created on the meta device and materialised by ``materialize``,
which draws every initial value from an explicit ``torch.Generator``:

  * ``torch_default_`` — Conv default, kaiming_uniform(a=sqrt(5));
  * ``orthogonal_relu_`` — orthogonal, gain sqrt(2) (IFNet);
  * ``normal_002_`` — normal(0, 0.02) (FusionNet), with BN weights
    normal(1, 0.02);
and conv biases uniform(+-1/sqrt(fan_in)) in every case, as PyTorch does.
Inside ``skip_init`` nothing is drawn (the values are loaded next).
"""

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from sstem_tpu_torch import config


def _mode(conv, w):
    """How a conv with weight ``w`` runs: ``"compute_dtype"`` (the bf16
    compute dtype), ``"bf16_pass"`` (the "default" precision's single
    pass) or None (in the weight's dtype)."""
    if w.dtype != torch.float32:
        return None
    if config.COMPUTE_DTYPE is not None and conv.follows_compute_dtype:
        return "compute_dtype"
    return "bf16_pass" if config.BF16_PASS else None


def _float32(y, bias):
    """A bf16 pass's result in float32, NCHW-contiguous (cuDNN may return
    a bf16 conv of a channels-last input in channels-last, where the
    float32 conv returned NCHW), with the bias added in float32."""
    y = y.to(torch.float32, memory_format=torch.contiguous_format)
    return y if bias is None else y + bias[None, :, None, None]


def _bf16(t):
    return None if t is None else t.to(torch.bfloat16)


class Conv2d(nn.Conv2d):
    follows_compute_dtype = True

    def forward(self, x):
        w = self.weight
        mode = _mode(self, w)
        if mode == "compute_dtype":
            # NCHW-contiguous, as the float32 conv returns it (see _float32)
            return self._conv_forward(_bf16(x), _bf16(w),
                                      _bf16(self.bias)).contiguous()
        if mode == "bf16_pass":
            y = self._conv_forward(_bf16(x), _bf16(w), None)
            return _float32(y, self.bias)
        return super().forward(x.to(w.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    follows_compute_dtype = True

    def forward(self, x, output_size=None):
        w = self.weight
        mode = _mode(self, w)
        if mode is None:
            return super().forward(x.to(w.dtype), output_size)
        op = self._output_padding(x, output_size, self.stride, self.padding,
                                  self.kernel_size, 2, self.dilation)
        bias = _bf16(self.bias) if mode == "compute_dtype" else None
        y = F.conv_transpose2d(_bf16(x), _bf16(w), bias, self.stride,
                               self.padding, op, self.groups, self.dilation)
        if mode == "compute_dtype":
            return y.contiguous()
        return _float32(y, self.bias)


class BatchNorm2d(nn.BatchNorm2d):
    def forward(self, x):
        return super().forward(x.to(self.weight.dtype)).to(x.dtype)


def conv3x3(cin, cout):
    return Conv2d(cin, cout, 3, 1, 1, device="meta")


def deconv2x(cin, cout):
    return ConvTranspose2d(cin, cout, 3, 2, 1, output_padding=1, device="meta")


def batchnorm(c):
    return BatchNorm2d(c, device="meta")


def torch_default_(w, g):
    nn.init.kaiming_uniform_(w, a=math.sqrt(5), generator=g)


def orthogonal_relu_(w, g):
    nn.init.orthogonal_(w, gain=math.sqrt(2.0), generator=g)


def normal_002_(w, g):
    nn.init.normal_(w, 0.0, 0.02, generator=g)


_SKIP_INIT = []


@contextlib.contextmanager
def skip_init():
    """Modules built inside allocate their parameters and draw no initial
    values: for a module whose every value is loaded next (a checkpoint
    loaded strictly), where orthogonal init would be wasted seconds."""
    _SKIP_INIT.append(True)
    try:
        yield
    finally:
        _SKIP_INIT.pop()


def materialize(module, generator, conv_weight_init, bn_weight_std=0.0):
    """Allocate ``module``'s meta parameters on the CPU and initialise them
    (unless inside ``skip_init``).

    Conv and ConvTranspose weights take ``conv_weight_init``; biases, where
    a layer has one, take PyTorch's default bound. BatchNorm weights are 1,
    or normal(1, std) when ``bn_weight_std`` is set; BN biases 0; running
    stats reset.
    """
    g = generator if generator is not None else torch.Generator()
    module.to_empty(device="cpu")
    if _SKIP_INIT:
        return module
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                conv_weight_init(m.weight, g)
                if m.bias is not None:
                    fan_in, _ = nn.init._calculate_fan_in_and_fan_out(m.weight)
                    bound = 1.0 / math.sqrt(fan_in)
                    nn.init.uniform_(m.bias, -bound, bound, generator=g)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()
                if bn_weight_std:
                    nn.init.normal_(m.weight, 1.0, bn_weight_std, generator=g)
                else:
                    nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
    return module


def cast_conv_weights(module, dtype):
    """Cast conv weights to ``dtype``; BatchNorm parameters stay float32.
    A conv with bf16 weights runs in bf16 whatever ``config``'s compute
    dtype says (the pipelines' ``dtype=``)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.to(dtype)
    return module


def float32_activations(module):
    """Keep ``module``'s convs out of the bf16 compute dtype: they cast a
    bf16 input to their float32 weights, as the JAX package's plain flax
    ``nn.Conv`` (VGG19, the discriminators) promotes it to its float32
    parameters. The ``"default"`` precision's bf16 pass still applies."""
    for m in module.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            m.follows_compute_dtype = False
    return module
