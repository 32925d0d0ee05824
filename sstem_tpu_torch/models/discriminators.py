"""GAN discriminator heads and the replay buffer (counterpart of
``sstem_tpu/models/discriminators.py``; reference
sff_scripts_interp/loss/loss_adversarial.py, defined there and wired into no
reference trainer):

  * ``Discriminator`` (:38-60): 4x4 stride-2 blocks 64/128/256 (instance
    norm after the first), ZeroPad2d((1, 0, 1, 0)), a 4x4 conv -> patch map
  * ``Discriminator2`` (:62-86): ngf blocks, a 4x4 conv, a global average
    pool -> (N, 1) score
  * ``Discriminator3`` (:88-110): as Discriminator2 but the patch map
  * ``NLayerDiscriminator`` (:112-156): the pix2pix PatchGAN with BatchNorm
  * ``PixelDiscriminator`` (:158-188): the 1x1 PatchGAN
  * ``ReplayBuffer`` (:16-35): a host image pool for the D updates

Every conv is 4x4 with padding 1 (1x1 in the pixel head), every activation a
leaky ReLU of slope 0.2, the instance norm ``nn.InstanceNorm2d`` (no affine,
no running statistics, eps 1e-5), the BatchNorm PyTorch's (momentum 0.1,
eps 1e-5) with its unbiased running variance, as the reference and the
port's other nets keep it (flax's BatchNorm in the JAX package keeps the
biased one). Layers sit in ``nn.Sequential`` containers in the reference's
order (``model`` in the first four, ``net`` in the pixel head);
``compat.weights.discriminator_state_dict_from_jax`` maps the JAX
package's variables onto them. NCHW throughout. The convs keep float32
under the bf16 compute dtype (``layers.float32_activations``), as the JAX
package's plain flax convs promote a bf16 input to float32.
"""

import random

import torch
from torch import nn

from sstem_tpu_torch.models import layers


def _conv4(cin, cout, stride, bias=True):
    return layers.Conv2d(cin, cout, 4, stride, 1, bias=bias, device="meta")


def _blocks(cin, widths):
    """4x4 stride-2 conv blocks, instance norm after all but the first,
    each with a leaky ReLU."""
    mods = []
    for i, cout in enumerate(widths):
        mods.append(_conv4(cin, cout, 2))
        if i:
            mods.append(nn.InstanceNorm2d(cout))
        mods.append(nn.LeakyReLU(0.2))
        cin = cout
    return mods


class Discriminator(nn.Module):
    """Patch discriminator with asymmetric final padding."""

    def __init__(self, in_channels=1, generator=None):
        super().__init__()
        self.model = nn.Sequential(*_blocks(in_channels, (64, 128, 256)),
                                   nn.ZeroPad2d((1, 0, 1, 0)),
                                   _conv4(256, 1, 1))
        layers.float32_activations(
            layers.materialize(self, generator, layers.torch_default_))

    def forward(self, x):
        return self.model(x)


class Discriminator3(nn.Module):
    """ngf-wide blocks and a 4x4 conv -> the patch map."""

    def __init__(self, in_channels=1, ngf=32, generator=None):
        super().__init__()
        self.model = nn.Sequential(
            *_blocks(in_channels, (ngf, ngf * 2, ngf * 4)),
            _conv4(ngf * 4, 1, 1))
        layers.float32_activations(
            layers.materialize(self, generator, layers.torch_default_))

    def forward(self, x):
        return self.model(x)


class Discriminator2(Discriminator3):
    """Discriminator3's patch map averaged globally -> (N, 1)."""

    def forward(self, x):
        return self.model(x).mean(dim=(2, 3))


def _batchnorm(c):
    return layers.BatchNorm2d(c, eps=1e-5, momentum=0.1, device="meta")


class NLayerDiscriminator(nn.Module):
    """pix2pix PatchGAN (BatchNorm variant). ``train()`` normalises with the
    batch statistics and updates the running ones, ``eval()`` uses them."""

    def __init__(self, in_channels=1, ndf=64, n_layers=3, generator=None):
        super().__init__()
        mods = [_conv4(in_channels, ndf, 2), nn.LeakyReLU(0.2)]
        nf = 1
        for n in range(1, n_layers + 1):
            prev, nf = nf, min(2 ** n, 8)
            mods += [_conv4(ndf * prev, ndf * nf, 2 if n < n_layers else 1,
                            bias=False),
                     _batchnorm(ndf * nf), nn.LeakyReLU(0.2)]
        mods.append(_conv4(ndf * nf, 1, 1))
        self.model = nn.Sequential(*mods)
        layers.float32_activations(
            layers.materialize(self, generator, layers.torch_default_))

    def forward(self, x):
        return self.model(x)


class PixelDiscriminator(nn.Module):
    """1x1 PatchGAN."""

    def __init__(self, in_channels=1, ndf=64, generator=None):
        super().__init__()
        self.net = nn.Sequential(
            layers.Conv2d(in_channels, ndf, 1, device="meta"), nn.LeakyReLU(0.2),
            layers.Conv2d(ndf, ndf * 2, 1, bias=False, device="meta"),
            _batchnorm(ndf * 2), nn.LeakyReLU(0.2),
            layers.Conv2d(ndf * 2, 1, 1, bias=False, device="meta"))
        layers.float32_activations(
            layers.materialize(self, generator, layers.torch_default_))

    def forward(self, x):
        return self.net(x)


class ReplayBuffer:
    """Host image pool (max 50) for the discriminator updates: the same
    draws from ``random.Random(seed)`` as the JAX package's, so the same
    pushes give the same pops."""

    def __init__(self, max_size: int = 50, seed: int = 0):
        if max_size <= 0:
            raise ValueError("ReplayBuffer: max_size must be positive")
        self.max_size = max_size
        self.data = []
        self._rng = random.Random(seed)

    def push_and_pop(self, batch):
        """``batch`` (N, ...) tensor -> (N, ...): each element passes
        through, or, once the pool is full, is swapped with a pooled one at
        even odds."""
        out = []
        for element in batch:
            element = element[None]
            if len(self.data) < self.max_size:
                self.data.append(element)
                out.append(element)
            elif self._rng.uniform(0, 1) > 0.5:
                i = self._rng.randint(0, self.max_size - 1)
                out.append(self.data[i].clone())
                self.data[i] = element
            else:
                out.append(element)
        return torch.cat(out, dim=0)
