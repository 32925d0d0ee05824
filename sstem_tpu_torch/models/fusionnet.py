"""FusionNet, the residual U-Net of the SFF flow stage (counterpart of
``sstem_tpu/models/fusionnet.py``; eval).

Conv_residual_conv blocks (conv_block -> conv_block_3 with a residual add ->
conv_block), four 2x2 max pools down, ConvTranspose(k3 s2 p1 op1) up with
skips averaged ``(deconv + down) / 2``, BatchNorm everywhere, LeakyReLU(0.2)
in the encoder and bridge, ReLU in the decoder, and a final 3x3 conv to
``output_nc`` channels (the 2-channel unfolding flow, channel 0 = dx).
Module names are the reference's (``down_1.conv_2.0.1``, ``deconv_1.0``,
``out``, ...). Init: conv weights normal(0, 0.02), BN weights normal(1, 0.02).
"""

import torch.nn.functional as F
from torch import nn

from sstem_tpu_torch.models.layers import (
    batchnorm,
    conv3x3,
    deconv2x,
    materialize,
    normal_002_,
)


def _conv_block(cin, cout, act):
    return nn.Sequential(conv3x3(cin, cout), batchnorm(cout), act())


def _conv_block_3(c, act):
    return nn.Sequential(_conv_block(c, c, act), _conv_block(c, c, act),
                         conv3x3(c, c), batchnorm(c))


def _leaky_relu_02():
    return nn.LeakyReLU(0.2)


class ConvResidualConv(nn.Module):
    def __init__(self, cin, cout, act):
        super().__init__()
        self.conv_1 = _conv_block(cin, cout, act)
        self.conv_2 = _conv_block_3(cout, act)
        self.conv_3 = _conv_block(cout, cout, act)

    def forward(self, x):
        c1 = self.conv_1(x)
        return self.conv_3(c1 + self.conv_2(c1))


class FusionNet(nn.Module):
    def __init__(self, input_nc=6, output_nc=2, ngf=32, generator=None):
        super().__init__()
        enc, dec = _leaky_relu_02, nn.ReLU
        self.down_1 = ConvResidualConv(input_nc, ngf, enc)
        self.down_2 = ConvResidualConv(ngf, ngf * 2, enc)
        self.down_3 = ConvResidualConv(ngf * 2, ngf * 4, enc)
        self.down_4 = ConvResidualConv(ngf * 4, ngf * 8, enc)
        self.bridge = ConvResidualConv(ngf * 8, ngf * 16, enc)
        self.deconv_1 = nn.Sequential(deconv2x(ngf * 16, ngf * 8),
                                      batchnorm(ngf * 8), dec())
        self.up_1 = ConvResidualConv(ngf * 8, ngf * 8, dec)
        self.deconv_2 = nn.Sequential(deconv2x(ngf * 8, ngf * 4),
                                      batchnorm(ngf * 4), dec())
        self.up_2 = ConvResidualConv(ngf * 4, ngf * 4, dec)
        self.deconv_3 = nn.Sequential(deconv2x(ngf * 4, ngf * 2),
                                      batchnorm(ngf * 2), dec())
        self.up_3 = ConvResidualConv(ngf * 2, ngf * 2, dec)
        self.deconv_4 = nn.Sequential(deconv2x(ngf * 2, ngf),
                                      batchnorm(ngf), dec())
        self.up_4 = ConvResidualConv(ngf, ngf, dec)
        self.out = conv3x3(ngf, output_nc)
        materialize(self, generator, normal_002_, bn_weight_std=0.02)

    def forward(self, x):
        down_1 = self.down_1(x)
        down_2 = self.down_2(F.max_pool2d(down_1, 2))
        down_3 = self.down_3(F.max_pool2d(down_2, 2))
        down_4 = self.down_4(F.max_pool2d(down_3, 2))
        bridge = self.bridge(F.max_pool2d(down_4, 2))
        up_1 = self.up_1((self.deconv_1(bridge) + down_4) / 2)
        up_2 = self.up_2((self.deconv_2(up_1) + down_3) / 2)
        up_3 = self.up_3((self.deconv_3(up_2) + down_2) / 2)
        up_4 = self.up_4((self.deconv_4(up_3) + down_1) / 2)
        return self.out(up_4)
