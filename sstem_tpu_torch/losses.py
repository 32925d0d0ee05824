"""Training losses (counterpart of ``sstem_tpu/losses.py``: the pixel losses
and the SSIM loss), on NCHW tensors.

  * ``l1_loss``, ``l2_loss`` — means over every element;
  * ``ssim`` / ``ssim_loss`` — the reference ``SSIMLoss`` (1 - SSIM): an
    11x11 Gaussian window with sigma 1.5, applied per channel as a grouped
    conv with SAME (zero) padding, on [0, 1] images
    (``sff_scripts_interp/loss/loss_ssim.py:74-135``).
"""

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred, target):
    return torch.mean((pred - target) ** 2)


@lru_cache(maxsize=16)
def _gauss_window(window_size: int, sigma: float):
    g = np.exp(
        -((np.arange(window_size) - window_size // 2) ** 2) / (2 * sigma**2)
    )
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def _grouped_blur(x, window_size: int, sigma: float):
    """Per-channel SAME conv with the Gaussian window (groups=C)."""
    c = x.shape[1]
    w = torch.from_numpy(_gauss_window(window_size, sigma)).to(x.device, x.dtype)
    w = w.expand(c, 1, window_size, window_size)
    return F.conv2d(x, w, padding=window_size // 2, groups=c)


def ssim(img1, img2, window_size: int = 11, max_val: float = 1.0):
    """SSIM over NCHW images; the training-loss dialect (SAME padding)."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu1 = _grouped_blur(img1, window_size, 1.5)
    mu2 = _grouped_blur(img2, window_size, 1.5)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _grouped_blur(img1 * img1, window_size, 1.5) - mu1_sq
    s2 = _grouped_blur(img2 * img2, window_size, 1.5) - mu2_sq
    s12 = _grouped_blur(img1 * img2, window_size, 1.5) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2.0 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return torch.mean(ssim_map)


def ssim_loss(pred, target, window_size: int = 11):
    """Reference ``SSIMLoss`` == 1 - SSIM on [0,1] images."""
    return 1.0 - ssim(pred, target, window_size, max_val=1.0)
