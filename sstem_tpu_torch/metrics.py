"""Image metrics (counterpart of ``sstem_tpu/metrics.py``): the host numpy
dialects, copied, and the device versions on torch tensors.

  * ``compute_psnr`` keeps the reference's quirk of returning the bare
    scalar 1e12, not a tuple, when mse < 1e-10
    (``sff_scripts_interp/utils/psnr_ssim.py:7-20``).
  * ``compute_ssim``: MATLAB fspecial-style 11x11 sigma=1.5 Gaussian
    window, 'valid' convolution, L=255 (``psnr_ssim.py:40-71``).
  * ``calculate_psnr`` / ``calculate_ssim``: the SP dialect, a cv2-style
    Gaussian window over uint8-range images in float64, range 255
    (``sp_scripts_train/utils/util.py:134-186``).
  * ``psnr`` / ``ssim``: on the tensors' device, for validation loops with
    no host round trip; the same formulas (``ssim`` with the MATLAB window
    and a valid convolution, centred globally before the variance terms).
"""

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


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
    from scipy.signal import convolve2d  # slow import

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


def calculate_psnr(img1, img2):
    """SP-dialect PSNR over uint8-range images (sp_scripts_train/utils/util.py:134)."""
    img1 = np.asarray(img1, dtype=np.float64)
    img2 = np.asarray(img2, dtype=np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 20 * math.log10(255.0 / math.sqrt(mse))


def _ssim_single(img1, img2):
    from scipy.signal import convolve2d  # slow import

    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    kernel = _cv2_gaussian_kernel(11, 1.5)
    window = np.outer(kernel, kernel.transpose())
    mu1 = convolve2d(img1, window, mode="valid")
    mu2 = convolve2d(img2, window, mode="valid")
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    s1 = convolve2d(img1**2, window, mode="valid") - mu1_sq
    s2 = convolve2d(img2**2, window, mode="valid") - mu2_sq
    s12 = convolve2d(img1 * img2, window, mode="valid") - mu1_mu2
    m = ((2 * mu1_mu2 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)
    )
    return m.mean()


def _cv2_gaussian_kernel(ksize, sigma):
    # cv2.getGaussianKernel equivalent
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(x**2) / (2 * sigma**2))
    return (k / k.sum()).reshape(-1, 1)


def calculate_ssim(img1, img2):
    """SP-dialect SSIM (cv2-window variant) over uint8-range images."""
    img1 = np.asarray(img1)
    img2 = np.asarray(img2)
    if img1.shape != img2.shape:
        raise ValueError("input images must have the same dimensions")
    if img1.ndim == 2:
        return float(_ssim_single(img1, img2))
    if img1.ndim == 3:
        if img1.shape[2] == 3:
            return float(np.mean([_ssim_single(img1[..., i], img2[..., i]) for i in range(3)]))
        if img1.shape[2] == 1:
            return float(_ssim_single(img1[..., 0], img2[..., 0]))
    raise ValueError("wrong input image dimensions")


# ---------------------------------------------------------------------------
# Device metrics (torch, on the tensors' device)
# ---------------------------------------------------------------------------

def psnr(img1, img2, max_val: float = 1.0):
    """PSNR over tensors in [0, max_val], in float32; the MSE is clamped at
    1e-12."""
    mse = torch.mean((img1.float() - img2.float()) ** 2)
    return 20.0 * math.log10(max_val) - 10.0 * torch.log10(
        torch.clamp(mse, min=1e-12))


@functools.lru_cache(maxsize=8)
def _gauss_window(win_size: int, sigma: float):
    return np.asarray(matlab_style_gauss2d((win_size, win_size), sigma),
                      np.float32)


def ssim(img1, img2, max_val: float = 255.0, win_size: int = 11,
         sigma: float = 1.5):
    """MATLAB-style SSIM on the tensors' device. Inputs (H, W) or (N, H, W)
    in [0, max_val]; float32, valid convolution."""
    if img1.dim() == 2:
        img1, img2 = img1[None], img2[None]
    x = img1.float()[:, None]
    y = img2.float()[:, None]
    win = torch.from_numpy(_gauss_window(win_size, sigma)).to(x.device)[None, None]

    def f(z):
        return F.conv2d(z, win)

    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    # centre globally before the variance terms: they are shift-invariant,
    # and centring avoids float32 cancellation in E[x^2] - mu^2
    mx = torch.mean(x)
    my = torch.mean(y)
    xc, yc = x - mx, y - my
    mu1c, mu2c = f(xc), f(yc)
    mu1, mu2 = mu1c + mx, mu2c + my
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = f(xc * xc) - mu1c * mu1c
    s2 = f(yc * yc) - mu2c * mu2c
    s12 = f(xc * yc) - mu1c * mu2c
    m = ((2 * mu1_mu2 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)
    )
    return torch.mean(m)
