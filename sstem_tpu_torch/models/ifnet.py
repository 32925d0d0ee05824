"""IFNet, the kernel-prediction interpolation net (counterpart of
``sstem_tpu/models/ifnet.py``: ``n_frames`` 1 (SFF) or 2 (SP),
``assume_gray``).

Input (N, 6, H, W): two gray neighbour sections, each replicated x3. A
5-level conv encoder 32..512 with 2x2 average pooling, a decoder with
align-corners 2x upsampling and additive skips, and four kernel heads, each
ending in a 2x align-corners upsample and ``conv3`` that emit K tap maps in
planar (N, K, H, W) layout. For each output frame two sepconvs apply them to
the replication-padded gray frames:

    y = sepconv(pad(i2), k2v, k2h) + sepconv(pad(i1), k1v, k1h)

The frames are gray, so the sepconv runs on one channel (the reference runs
three identical ones and takes their mean). Module names are the reference's
(``conv32.0``, ``upsamp512.1``, ``upconv51_1.7``, ...). The SFF net
(``n_frames=1``, model_interp.py) has four heads, ``upconv51_1..4`` = k2h,
k2v, k1h, k1v. The SP net (``n_frames=2``, sp_scripts_train/networks.py)
has four per frame in another order: ``upconv51_11..14`` = k1h, k1v, k2h,
k2v of section 2, ``upconv51_21..24`` the same of section 3 (the JAX
importer's ``load_torch_ifnet(n_frames=2)``); the reference's eight unused
heads ``upconv51_15..18`` and ``_25..28`` are not built. Init: orthogonal,
gain sqrt(2).
"""

import torch
import torch.nn.functional as F
from torch import nn

from sstem_tpu_torch import config
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


# head names per output frame, in (k2h, k2v, k1h, k1v) order
HEADS = {
    1: (("upconv51_1", "upconv51_2", "upconv51_3", "upconv51_4"),),
    2: tuple((f"upconv51_{f}3", f"upconv51_{f}4", f"upconv51_{f}1",
              f"upconv51_{f}2") for f in (1, 2)),
}


class IFNet(nn.Module):
    def __init__(self, kernel_size=51, n_frames=1, generator=None):
        super().__init__()
        if n_frames not in HEADS:
            raise ValueError(f"IFNet: n_frames must be 1 or 2, got {n_frames}")
        self.kernel_size = kernel_size
        self.n_frames = n_frames
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
        for name in sorted(n for frame in HEADS[n_frames] for n in frame):
            setattr(self, name, _kernel_head(kernel_size))
        materialize(self, generator, orthogonal_relu_)

    def forward(self, x):
        """(N, 6, H, W), H and W multiples of 32 -> (N, n_frames, H, W)."""
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

        # the padded frames travel in the dtype of the tap maps: the conv
        # weights', or with float32 weights the bf16 compute dtype where set
        # (the JAX planar path casts its frames to it)
        cdt = self.conv32[0].weight.dtype
        if cdt == torch.float32 and config.COMPUTE_DTYPE is not None:
            cdt = config.COMPUTE_DTYPE
        pad = self.kernel_size // 2
        p1 = replication_pad_2d(i1, pad).to(cdt)
        p2 = replication_pad_2d(i2, pad).to(cdt)
        outs = []
        for frame in HEADS[self.n_frames]:
            k2h, k2v, k1h, k1v = (getattr(self, name)(x) for name in frame)
            outs.append(sepconv_planar(p2, k2v, k2h)
                        + sepconv_planar(p1, k1v, k1h))
        return outs[0] if len(outs) == 1 else torch.cat(outs, 1)
