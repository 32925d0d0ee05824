"""VGG19 feature extractor for the perceptual loss (counterpart of
``sstem_tpu/models/vgg.py``).

The reference (sff_scripts_interp/loss/loss_vgg.py:37-158) splits
torchvision's VGG19 ``features`` trunk at every ReLU; the perceptual loss
reads the relu{1,2,3,4,5}_1 taps only, so this module runs the trunk through
conv5_1 and returns those five. Its layers sit at torchvision's indices in
``features``, so its state dict keys are torchvision's
(``features.{0,2,5,7,10,12,14,16,19,21,23,25,28}.{weight,bias}``) and the
published ``vgg19-dcbb9e9d.pth`` loads through
``load_torch_vgg19_features`` as it is.

No input normalisation: the reference feeds raw [0, 1] gray images repeated
to 3 channels (main_ms.py:195-198). The extractor is frozen where the loss
uses it (``cli/_sff.load_vgg_apply``: eval mode, no parameter takes a
gradient, outside every optimizer and checkpoint).
"""

import torch
from torch import nn

from sstem_tpu_torch.models import layers

# torchvision cfg 'E' through conv5_1: channels of each conv, "M" a 2x2 max
# pool; each conv is followed by a ReLU
_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
        512, 512, 512, 512, "M", 512)

# torchvision vgg19.features indices of the 13 convs above
TORCH_IDX = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28)

# the ReLU index in ``features`` of each tap
_TAPS = {1: "relu1_1", 6: "relu2_1", 11: "relu3_1", 20: "relu4_1",
         29: "relu5_1"}


class VGG19Features(nn.Module):
    """NCHW (N, 3, H, W) -> {'relu1_1', 'relu2_1', 'relu3_1', 'relu4_1',
    'relu5_1'}. Weights from ``generator`` (PyTorch's default conv init)
    unless they are loaded next."""

    def __init__(self, generator=None):
        super().__init__()
        mods, cin = [], 3
        for v in _CFG:
            if v == "M":
                mods.append(nn.MaxPool2d(2, 2))
            else:
                mods += [layers.conv3x3(cin, v), nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*mods)
        layers.materialize(self, generator, layers.torch_default_)

    def forward(self, x):
        out = {}
        for i, m in enumerate(self.features):
            x = m(x)
            if i in _TAPS:
                out[_TAPS[i]] = x
        return out


def load_torch_vgg19_features(path):
    """The 13 conv weights and biases through conv5_1 out of a torchvision
    VGG19 state dict file (``features.N.*``; the classifier and the deeper
    convs are left out): a state dict for ``VGG19Features``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {f"features.{i}.{k}": sd[f"features.{i}.{k}"]
            for i in TORCH_IDX for k in ("weight", "bias")}


# torchvision's VGG19 ``features`` convs past conv5_1 (conv5_2..conv5_4),
# which a full state dict carries and this module leaves out
_DEEPER_IDX = (30, 32, 34)


def seeded_torchvision_vgg19(seed=0):
    """A VGG19 ``features`` state dict in torchvision's layout (all 16
    convs, through conv5_4) from ``seed``: He-normal weights, biases
    U(-0.05, 0.05). The published ImageNet weights are not in the
    repository and are not fetched; the tests and the smoke run write this
    file in their place."""
    g = torch.Generator().manual_seed(seed)
    channels = [v for v in _CFG if v != "M"] + [512] * len(_DEEPER_IDX)
    sd, cin = {}, 3
    for idx, cout in zip(TORCH_IDX + _DEEPER_IDX, channels):
        std = (2.0 / (cin * 9)) ** 0.5
        sd[f"features.{idx}.weight"] = torch.randn(
            cout, cin, 3, 3, generator=g) * std
        sd[f"features.{idx}.bias"] = (torch.rand(cout, generator=g) - 0.5) * 0.1
        cin = cout
    return sd
