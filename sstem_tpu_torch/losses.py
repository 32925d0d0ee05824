"""Training losses (counterpart of ``sstem_tpu/losses.py``: the pixel losses,
the SSIM loss and the flow end-point error family).

  * ``l1_loss``, ``l2_loss`` — means over every element;
  * ``ssim`` / ``ssim_loss`` — the reference ``SSIMLoss`` (1 - SSIM): an
    11x11 Gaussian window with sigma 1.5, applied per channel as a grouped
    conv with SAME (zero) padding, on [0, 1] NCHW images
    (``sff_scripts_interp/loss/loss_ssim.py:74-135``);
  * ``epe``, ``sparse_max_pool``, ``multiscale_epe``, ``real_epe`` — the
    reference ``multiscaleloss.py`` on NHWC flows (channel 0 = dx), as the
    JAX package writes them.
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


# ---------------------------------------------------------------------------
# Flow end-point error (NHWC flows, C = 2)
# ---------------------------------------------------------------------------

def epe(pred_flow, target_flow, sparse: bool = False, mean: bool = True):
    """End-point error over NHWC flows.

    sparse: pixels where both target components are exactly 0 are invalid
    (multiscaleloss.py:8-12), a masked mean.
    """
    epe_map = torch.linalg.vector_norm(target_flow - pred_flow, ord=2, dim=-1)
    n = pred_flow.shape[0]
    if sparse:
        valid = ~((target_flow[..., 0] == 0) & (target_flow[..., 1] == 0))
        total = torch.sum(epe_map * valid)
        if mean:
            return total / torch.clamp(valid.sum(), min=1)
        return total / n
    if mean:
        return torch.mean(epe_map)
    return torch.sum(epe_map) / n


def _window(x, size):
    h, w = x.shape[1], x.shape[2]
    oh, ow = size
    assert h % oh == 0 and w % ow == 0, "pooling needs divisible sizes"
    return h // oh, w // ow


def _pool_nhwc(pool, x, k):
    return pool(x.permute(0, 3, 1, 2), k, k).permute(0, 2, 3, 1)


def sparse_max_pool(x, size):
    """Downsample an NHWC flow treating exact 0 as invalid: max-pool of the
    positives minus max-pool of the negatives' magnitudes
    (multiscaleloss.py:19-31). Requires divisible sizes."""
    k = _window(x, size)
    pos = torch.where(x > 0, x, 0.0)
    neg = torch.where(x < 0, -x, 0.0)
    return _pool_nhwc(F.max_pool2d, pos, k) - _pool_nhwc(F.max_pool2d, neg, k)


def _area_downsample(x, size):
    return _pool_nhwc(F.avg_pool2d, x, _window(x, size))


def multiscale_epe(network_outputs, target_flow, weights=None, sparse=False):
    """Reference ``multiscaleEPE`` (weights from the FlowNet article)."""
    if not isinstance(network_outputs, (tuple, list)):
        network_outputs = [network_outputs]
    if weights is None:
        weights = [0.005, 0.01, 0.02, 0.08, 0.32]
    assert len(weights) == len(network_outputs)
    loss = 0.0
    for out, wgt in zip(network_outputs, weights):
        size = (out.shape[1], out.shape[2])
        tgt = (sparse_max_pool(target_flow, size) if sparse
               else _area_downsample(target_flow, size))
        loss = loss + wgt * epe(out, tgt, sparse, mean=False)
    return loss


def real_epe(pred_flow, target_flow, sparse=False):
    """EPE of the prediction resized to the target's size (bilinear,
    half-pixel centres, as ``jax.image.resize(..., 'linear')``; a smaller
    prediction is antialiased as JAX does)."""
    h, w = target_flow.shape[1], target_flow.shape[2]
    x = pred_flow.permute(0, 3, 1, 2)
    up = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                       antialias=h < x.shape[2] or w < x.shape[3])
    return epe(up.permute(0, 2, 3, 1), target_flow, sparse, mean=True)
