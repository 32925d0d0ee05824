"""Layers and initializers (counterpart of ``sstem_tpu/models/layers.py``).

Conv2d(k3 s1 p1), ConvTranspose2d(k3 s2 p1 op1) and BatchNorm2d are PyTorch's
own; BatchNorm2d's running variance is already the unbiased one. The
subclasses here only add the numerical policy of ``config.py``: a conv
runs in its weight's dtype and casts its input on entry (as JAX's
``Conv2dTorch`` casts to ``compute_dtype()``), except that under the
``"default"`` matmul precision a conv with float32 weights runs one bf16
pass (input and weight cast to bf16, the result back to float32, the bias
added in float32: JAX's ``Precision.DEFAULT``); BatchNorm normalises in
its parameters' dtype (float32; float64 for a model cast whole, as the
training-parity tests run it) and emits its input's dtype.

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


def _bf16_pass(w):
    """Whether a conv with weight ``w`` runs the single bf16 pass."""
    return config.BF16_PASS and w.dtype == torch.float32


def _float32(y, bias):
    """A bf16 pass's result in float32, NCHW-contiguous (cuDNN may return
    a bf16 conv of a channels-last input in channels-last, where the
    float32 conv returned NCHW), with the bias added in float32."""
    y = y.to(torch.float32, memory_format=torch.contiguous_format)
    return y if bias is None else y + bias[None, :, None, None]


class Conv2d(nn.Conv2d):
    def forward(self, x):
        w = self.weight
        if _bf16_pass(w):
            y = self._conv_forward(x.to(torch.bfloat16), w.to(torch.bfloat16),
                                   None)
            return _float32(y, self.bias)
        return super().forward(x.to(w.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x, output_size=None):
        w = self.weight
        if _bf16_pass(w):
            op = self._output_padding(x, output_size, self.stride,
                                      self.padding, self.kernel_size, 2,
                                      self.dilation)
            y = F.conv_transpose2d(
                x.to(torch.bfloat16), w.to(torch.bfloat16), None, self.stride,
                self.padding, op, self.groups, self.dilation)
            return _float32(y, self.bias)
        return super().forward(x.to(w.dtype), output_size)


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


def set_compute_dtype(module, dtype):
    """Cast conv weights to ``dtype``; BatchNorm parameters stay float32."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.to(dtype)
    return module
