"""IFNet, the kernel-prediction interpolation net, SFF variant (counterpart of
``sstem_tpu/models/ifnet.py``: 1 frame, ``assume_gray``, eval).

Input (N, 6, H, W): two gray neighbour sections, each replicated x3. A
5-level conv encoder 32..512 with 2x2 average pooling, a decoder with
align-corners 2x upsampling and additive skips, and four kernel heads, each
ending in a 2x align-corners upsample and ``conv3`` that emit K tap maps in
planar (N, K, H, W) layout. Two sepconvs apply them to the replication-padded
gray frames:

    y = sepconv(pad(i2), k2v, k2h) + sepconv(pad(i1), k1v, k1h)

The frames are gray, so the sepconv runs on one channel (the reference runs
three identical ones and takes their mean). Module names are the reference's
(``conv32.0``, ``upsamp512.1``, ``upconv51_1.7``, ...); heads 1..4 are
k2h, k2v, k1h, k1v. Init: orthogonal, gain sqrt(2).
"""

import torch.nn.functional as F
from torch import nn

from sstem_tpu_torch.kernels import sepconv_planar
from sstem_tpu_torch.models.layers import conv3x3, materialize, orthogonal_relu_
from sstem_tpu_torch.ops import replication_pad_2d, upsample_bilinear_align_corners


class Upsample2x(nn.Module):
    def forward(self, x):
        return upsample_bilinear_align_corners(x, 2)


def _conv_module(cin, cout):
    return nn.Sequential(conv3x3(cin, cin), nn.ReLU(), conv3x3(cin, cin),
                         nn.ReLU(), conv3x3(cin, cout), nn.ReLU())


def _upsample_module(cin, cout):
    return nn.Sequential(Upsample2x(), conv3x3(cin, cout), nn.ReLU())


def _kernel_head(k):
    return nn.Sequential(conv3x3(64, 64), nn.ReLU(), conv3x3(64, 64), nn.ReLU(),
                         conv3x3(64, k), nn.ReLU(), Upsample2x(), conv3x3(k, k))


class IFNet(nn.Module):
    def __init__(self, kernel_size=51, generator=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.conv32 = _conv_module(6, 32)
        self.conv64 = _conv_module(32, 64)
        self.conv128 = _conv_module(64, 128)
        self.conv256 = _conv_module(128, 256)
        self.conv512 = _conv_module(256, 512)
        self.conv512x512 = _conv_module(512, 512)
        self.upsamp512 = _upsample_module(512, 512)
        self.upconv256 = _conv_module(512, 256)
        self.upsamp256 = _upsample_module(256, 256)
        self.upconv128 = _conv_module(256, 128)
        self.upsamp128 = _upsample_module(128, 128)
        self.upconv64 = _conv_module(128, 64)
        self.upsamp64 = _upsample_module(64, 64)
        self.upconv51_1 = _kernel_head(kernel_size)
        self.upconv51_2 = _kernel_head(kernel_size)
        self.upconv51_3 = _kernel_head(kernel_size)
        self.upconv51_4 = _kernel_head(kernel_size)
        materialize(self, generator, orthogonal_relu_)

    def forward(self, x):
        """(N, 6, H, W), H and W multiples of 32 -> (N, 1, H, W)."""
        i1 = x[:, 0:1]
        i2 = x[:, 3:4]

        x = self.conv32(x)
        x64 = self.conv64(F.avg_pool2d(x, 2))
        x128 = self.conv128(F.avg_pool2d(x64, 2))
        x256 = self.conv256(F.avg_pool2d(x128, 2))
        x512 = self.conv512(F.avg_pool2d(x256, 2))
        x = self.conv512x512(F.avg_pool2d(x512, 2))

        x = self.upconv256(self.upsamp512(x) + x512)
        x = self.upconv128(self.upsamp256(x) + x256)
        x = self.upconv64(self.upsamp128(x) + x128)
        x = self.upsamp64(x) + x64

        # the padded frames travel in the compute dtype, as the tap maps do
        cdt = self.conv32[0].weight.dtype
        pad = self.kernel_size // 2
        p1 = replication_pad_2d(i1, pad).to(cdt)
        p2 = replication_pad_2d(i2, pad).to(cdt)
        k2h = self.upconv51_1(x)
        k2v = self.upconv51_2(x)
        k1h = self.upconv51_3(x)
        k1v = self.upconv51_4(x)
        return sepconv_planar(p2, k2v, k2h) + sepconv_planar(p1, k1v, k1h)
