"""UNetSFF, the 3-level fusion U-Net of the SFF pipeline (counterpart of
``sstem_tpu/models/unet_sff.py``; reference class name ``UNet``; eval).

Contracting blocks (conv+BN+ReLU x2) at 32/64/128 with 2x2 max pools, a
bottleneck conv(128->256), conv(256->128), ConvTranspose(128->128), a
decoder that concatenates (upsampled, bypass) before each expanding block,
and a final block conv(64->32), conv(32->out), each with BN and ReLU: the
output activation is ReLU in the reference. Module names are the
reference's (``conv_encode1.0``, ``bottleneck.6``, ``final_layer.4``, ...).
Init: PyTorch's defaults.
"""

import torch
import torch.nn.functional as F
from torch import nn

from sstem_tpu_torch.models.layers import (
    batchnorm,
    conv3x3,
    deconv2x,
    materialize,
    torch_default_,
)


def _cbr(cin, cout, layer=conv3x3):
    return [layer(cin, cout), batchnorm(cout), nn.ReLU()]


def _contract(cin, cout):
    return nn.Sequential(*_cbr(cin, cout), *_cbr(cout, cout))


def _expand(cin, mid, cout):
    return nn.Sequential(*_cbr(cin, mid), *_cbr(mid, mid),
                         *_cbr(mid, cout, deconv2x))


class UNetSFF(nn.Module):
    def __init__(self, in_channel=6, out_channel=1, generator=None):
        super().__init__()
        self.conv_encode1 = _contract(in_channel, 32)
        self.conv_encode2 = _contract(32, 64)
        self.conv_encode3 = _contract(64, 128)
        self.bottleneck = nn.Sequential(*_cbr(128, 256), *_cbr(256, 128),
                                        *_cbr(128, 128, deconv2x))
        self.conv_decode3 = _expand(256, 128, 64)
        self.conv_decode2 = _expand(128, 64, 32)
        self.final_layer = nn.Sequential(*_cbr(64, 32),
                                         *_cbr(32, out_channel))
        materialize(self, generator, torch_default_)

    def forward(self, x):
        e1 = self.conv_encode1(x)
        e2 = self.conv_encode2(F.max_pool2d(e1, 2))
        e3 = self.conv_encode3(F.max_pool2d(e2, 2))
        b = self.bottleneck(F.max_pool2d(e3, 2))
        c2 = self.conv_decode3(torch.cat([b, e3], 1))
        c1 = self.conv_decode2(torch.cat([c2, e2], 1))
        return self.final_layer(torch.cat([c1, e1], 1))
