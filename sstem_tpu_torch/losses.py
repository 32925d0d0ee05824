"""Training losses (counterpart of ``sstem_tpu/losses.py``: the whole loss
zoo).

  * ``l1_loss``, ``l2_loss`` — means over every element;
  * ``ssim`` / ``ssim_loss`` — the reference ``SSIMLoss`` (1 - SSIM): an
    11x11 Gaussian window with sigma 1.5, applied per channel as a grouped
    conv with SAME (zero) padding, on [0, 1] NCHW images
    (``sff_scripts_interp/loss/loss_ssim.py:74-135``); one bf16 pass under
    the ``"default"`` matmul precision (``config.py``), as JAX's;
  * ``ms_ssim`` — the reference ``MS_SSIM`` (5 levels, window min(h, w, 11)
    with sigma scaled to it, a 2x2 average pool between levels, weights
    [0.0448, 0.2856, 0.3001, 0.2363, 0.1333], product form; max_val 255 by
    default) (``sff_scripts_unfolding/loss/loss_ssim.py:18-73``);
  * ``epe``, ``sparse_max_pool``, ``multiscale_epe``, ``real_epe`` — the
    reference ``multiscaleloss.py`` on NHWC flows (channel 0 = dx), as the
    JAX package writes them;
  * ``gan_loss`` (lsgan, vanilla, wgangp), ``g_loss``, ``d_loss`` — the
    reference ``GANLoss``, ``G_LOSS``, ``AD_LOSS``
    (``sff_scripts_interp/loss/loss_adversarial.py:190-283``);
  * ``vgg_feature_loss``, ``perceptual_loss`` — VGG19 relu{1..5}_1 taps, L1
    or L2; gray NCHW images repeated to 3 channels, no ImageNet
    normalisation (``loss_vgg.py:6-34,160-179`` + ``main_ms.py:193-200``).
"""

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from sstem_tpu_torch import config


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
    if config.BF16_PASS and x.dtype == torch.float32:
        # the "default" policy's single bf16 pass (config.py)
        return F.conv2d(x.to(torch.bfloat16), w.to(torch.bfloat16),
                        padding=window_size // 2, groups=c).float()
    return F.conv2d(x, w, padding=window_size // 2, groups=c)


def _ssim_parts(img1, img2, window_size: int, sigma: float, max_val: float):
    """The SSIM and contrast-structure maps of NCHW images."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu1 = _grouped_blur(img1, window_size, sigma)
    mu2 = _grouped_blur(img2, window_size, sigma)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _grouped_blur(img1 * img1, window_size, sigma) - mu1_sq
    s2 = _grouped_blur(img2 * img2, window_size, sigma) - mu2_sq
    s12 = _grouped_blur(img1 * img2, window_size, sigma) - mu1_mu2
    v1 = 2.0 * s12 + c2
    v2 = s1 + s2 + c2
    ssim_map = ((2 * mu1_mu2 + c1) * v1) / ((mu1_sq + mu2_sq + c1) * v2)
    return ssim_map, v1 / v2


def ssim(img1, img2, window_size: int = 11, max_val: float = 1.0):
    """SSIM over NCHW images; the training-loss dialect (SAME padding)."""
    ssim_map, _ = _ssim_parts(img1, img2, window_size, 1.5, max_val)
    return torch.mean(ssim_map)


def ssim_loss(pred, target, window_size: int = 11):
    """Reference ``SSIMLoss`` == 1 - SSIM on [0,1] images."""
    return 1.0 - ssim(pred, target, window_size, max_val=1.0)


MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def ms_ssim(img1, img2, levels: int = 5, max_val: float = 255.0):
    """Reference ``MS_SSIM`` over NCHW images: the product of the first
    levels' contrast terms and the last level's SSIM, each to its weight."""
    weights = torch.tensor(MS_SSIM_WEIGHTS[:levels], dtype=img1.dtype,
                           device=img1.device)
    msssim, mcs = [], []
    for _ in range(levels):
        ws = min(img1.shape[2], img1.shape[3], 11)
        ssim_map, cs_map = _ssim_parts(img1, img2, ws, 1.5 * ws / 11, max_val)
        msssim.append(torch.mean(ssim_map))
        mcs.append(torch.mean(cs_map))
        # 2x2 VALID average pool (odd sizes floor)
        img1 = F.avg_pool2d(img1, 2, 2)
        img2 = F.avg_pool2d(img2, 2, 2)
    mcs = torch.stack(mcs)
    return (torch.prod(mcs[:levels - 1] ** weights[:levels - 1])
            * msssim[levels - 1] ** weights[levels - 1])


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


# ---------------------------------------------------------------------------
# GAN objectives
# ---------------------------------------------------------------------------

def gan_loss(prediction, target_is_real: bool, mode: str = "lsgan"):
    """Reference ``GANLoss``: lsgan (MSE to the label), vanilla
    (BCE-with-logits), wgangp (signed mean)."""
    if mode == "lsgan":
        target = 1.0 if target_is_real else 0.0
        return torch.mean((prediction - target) ** 2)
    if mode == "vanilla":
        target = (torch.ones_like(prediction) if target_is_real
                  else torch.zeros_like(prediction))
        # max(x, 0) - x z + log(1 + exp(-|x|)), averaged
        return F.binary_cross_entropy_with_logits(prediction, target)
    if mode == "wgangp":
        return -torch.mean(prediction) if target_is_real else torch.mean(prediction)
    raise NotImplementedError(f"gan mode {mode} not implemented")


def g_loss(pred_fake, mode: str = "lsgan"):
    """Generator adversarial term (loss_adversarial.py:260-268)."""
    return gan_loss(pred_fake, True, mode)


def d_loss(pred_fake, pred_real, mode: str = "lsgan"):
    """Discriminator term, 0.5 * (real + fake) (loss_adversarial.py:271-283)."""
    return 0.5 * (gan_loss(pred_real, True, mode)
                  + gan_loss(pred_fake, False, mode))


# ---------------------------------------------------------------------------
# Perceptual (VGG19) loss
# ---------------------------------------------------------------------------

VGG_TAPS = ("relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1")


def vgg_feature_loss(feats1, feats2, mode: int = 2, weights=(1.0,) * 5):
    """Reference ``vgg_loss``: (L1 if mode == 1 else L2) over the
    relu{1..5}_1 taps."""
    crit = l1_loss if mode == 1 else l2_loss
    loss = 0.0
    for wgt, tap in zip(weights, VGG_TAPS):
        loss = loss + wgt * crit(feats1[tap], feats2[tap])
    return loss


def perceptual_loss(vgg_apply, pred, target, vgg_weight=1.0, com_weight=1.0,
                    combine: str = "L1", mode: int = 1):
    """The perceptual objective as main_ms.py:193-200 wires it: the gray
    NCHW prediction and target, repeated to 3 channels, go through VGG19
    (``vgg_apply`` returns the taps), and the feature term (L1 by default,
    ``mode``) is added to a pixel term (``combine``)."""
    crit = l1_loss if combine == "L1" else l2_loss
    loss_com = crit(pred, target)
    f1 = vgg_apply(torch.cat([pred] * 3, dim=1))
    f2 = vgg_apply(torch.cat([target] * 3, dim=1))
    return com_weight * loss_com + vgg_weight * vgg_feature_loss(f1, f2, mode)
