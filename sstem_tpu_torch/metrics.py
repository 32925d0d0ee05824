"""Host image metrics (counterpart of ``sstem_tpu/metrics.py``'s numpy
dialect: ``compute_psnr``, ``matlab_style_gauss2d``, ``_filter2`` and
``compute_ssim``, copied).

  * ``compute_psnr`` keeps the reference's quirk of returning the bare
    scalar 1e12, not a tuple, when mse < 1e-10
    (``sff_scripts_interp/utils/psnr_ssim.py:7-20``).
  * ``compute_ssim``: MATLAB fspecial-style 11x11 sigma=1.5 Gaussian
    window, 'valid' convolution, L=255 (``psnr_ssim.py:40-71``).
"""

import math

import numpy as np
from scipy.signal import convolve2d


def compute_psnr(img1, img2):
    """Reference-parity PSNR. Returns (mse, psnr), or bare 1e12 if mse ~ 0."""
    img1 = np.asarray(img1)
    img2 = np.asarray(img2)
    if np.max(img1) <= 1.0 and np.max(img2) <= 1.0:
        mse = np.mean((img1 - img2) ** 2)
    else:
        mse = np.mean((img1 / 255.0 - img2 / 255.0) ** 2)
    if mse < 1.0e-10:
        return 1000000000000
    return mse, 20 * math.log10(1.0 / math.sqrt(mse))


def matlab_style_gauss2d(shape=(3, 3), sigma=0.5):
    """MATLAB fspecial('gaussian') window."""
    m, n = [(s - 1.0) / 2.0 for s in shape]
    y, x = np.ogrid[-m : m + 1, -n : n + 1]
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    s = h.sum()
    if s != 0:
        h /= s
    return h


def _filter2(x, kernel, mode="same"):
    return convolve2d(x, np.rot90(kernel, 2), mode=mode)


def compute_ssim(im1, im2, k1=0.01, k2=0.03, win_size=11, L=255):
    """Reference-parity MATLAB-style SSIM over a single-channel image."""
    im1 = np.asarray(im1)
    im2 = np.asarray(im2)
    if np.max(im1) <= 1.0 and np.max(im2) <= 1.0:
        im1 = (im1 * 255).astype(np.uint8)
        im2 = (im2 * 255).astype(np.uint8)
    if im1.shape != im2.shape:
        raise ValueError("input images must have the same dimensions")
    if im1.ndim > 2:
        raise ValueError("expected single-channel images")

    c1 = (k1 * L) ** 2
    c2 = (k2 * L) ** 2
    window = matlab_style_gauss2d((win_size, win_size), sigma=1.5)
    window = window / window.sum()

    im1 = np.double(im1)
    im2 = np.double(im2)
    mu1 = _filter2(im1, window, "valid")
    mu2 = _filter2(im2, window, "valid")
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _filter2(im1 * im1, window, "valid") - mu1_sq
    s2 = _filter2(im2 * im2, window, "valid") - mu2_sq
    s12 = _filter2(im1 * im2, window, "valid") - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)
    )
    return float(np.mean(ssim_map))
