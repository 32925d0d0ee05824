"""Host image metrics (counterpart of ``sstem_tpu/metrics.py``'s numpy
dialect: ``compute_psnr``).

``compute_psnr`` keeps the reference's quirk of returning the bare scalar
1e12, not a tuple, when mse < 1e-10
(``sff_scripts_interp/utils/psnr_ssim.py:7-20``).
"""

import math

import numpy as np


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
