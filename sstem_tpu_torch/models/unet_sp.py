"""The SP U-Nets: the milesial 4-level denoising U-Net and the additive
fusion net (counterpart of ``sstem_tpu/models/unet_sp.py``: ``UNetSP``,
``FusionNetSP``; reference ``sp_scripts_train/networks.py:243-306``).

DoubleConv (conv+BN+ReLU x2) at 64/128/256/512/512 with 2x2 max pools, and
four Up blocks that upsample bilinearly (align corners), pad to the skip's
size as ``(d // 2, d - d // 2)``, concatenate ``[skip, upsampled]`` and run a
DoubleConv whose middle width is the input's half; a 1x1 ``outc``.
``FusionNetSP`` is the same net run on the sum of its two inputs. Module
names are the reference's (``inc.double_conv.0``,
``down1.maxpool_conv.1.double_conv.3``, ``up4.conv.double_conv.4``,
``outc.conv``), which ``load_torch_unet_sp`` reads. Init: PyTorch's
defaults.
"""

import torch
import torch.nn.functional as F
from torch import nn

from sstem_tpu_torch.models.layers import (
    Conv2d,
    batchnorm,
    conv3x3,
    materialize,
    torch_default_,
)
from sstem_tpu_torch.ops import upsample_bilinear_align_corners


class DoubleConv(nn.Module):
    def __init__(self, cin, cout, mid=None):
        super().__init__()
        mid = mid or cout
        self.double_conv = nn.Sequential(
            conv3x3(cin, mid), batchnorm(mid), nn.ReLU(),
            conv3x3(mid, cout), batchnorm(cout), nn.ReLU())

    def forward(self, x):
        return self.double_conv(x)


class Down(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2),
                                          DoubleConv(cin, cout))

    def forward(self, x):
        return self.maxpool_conv(x)


class Up(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = DoubleConv(cin, cout, cin // 2)

    def forward(self, x1, x2):
        x1 = upsample_bilinear_align_corners(x1, 2)
        dh = x2.shape[2] - x1.shape[2]
        dw = x2.shape[3] - x1.shape[3]
        if dh or dw:
            x1 = F.pad(x1, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.conv(torch.cat([x2, x1], 1))


class OutConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Conv2d(cin, cout, 1, device="meta")

    def forward(self, x):
        return self.conv(x)


class UNetSP(nn.Module):
    """SP denoising U-Net (reference ``UNet(n_channels=1, n_classes)``):
    (N, 1, H, W) -> (N, n_classes, H, W)."""

    def __init__(self, n_classes=1, generator=None):
        super().__init__()
        self.inc = DoubleConv(1, 64)
        self.down1 = Down(64, 128)
        self.down2 = Down(128, 256)
        self.down3 = Down(256, 512)
        self.down4 = Down(512, 512)  # 1024 // 2, bilinear
        self.up1 = Up(1024, 256)
        self.up2 = Up(512, 128)
        self.up3 = Up(256, 64)
        self.up4 = Up(128, 64)
        self.outc = OutConv(64, n_classes)
        materialize(self, generator, torch_default_)

    def forward(self, x):
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        x = self.up1(x5, x4)
        x = self.up2(x, x3)
        x = self.up3(x, x2)
        x = self.up4(x, x1)
        return self.outc(x)


class FusionNetSP(UNetSP):
    """SP fusion net (networks.py:275-306): the U-Net on ``x1 + x2``."""

    def forward(self, x1, x2):
        return super().forward(x1 + x2)
