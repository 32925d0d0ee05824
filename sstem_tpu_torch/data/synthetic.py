"""Synthetic ssTEM-like stacks (counterpart of ``sstem_tpu/data/synthetic.py``:
``synth_stack``), numpy and scipy only.

Band-limited noise textures with strong z-correlation, so adjacent sections
look alike as in a real serial-section stack. The same seed gives the same
stack as the JAX package's ``synth_stack``.
"""

import numpy as np
from scipy.ndimage import gaussian_filter


def synth_stack(n_sections=8, height=512, width=512, seed=0,
                z_corr=0.9, feature_scale=6.0):
    """(Z, H, W) uint8 stack of correlated textures."""
    rng = np.random.default_rng(seed)
    base = gaussian_filter(rng.standard_normal((height, width)), feature_scale)
    out = []
    prev = base
    for _ in range(n_sections):
        innov = gaussian_filter(rng.standard_normal((height, width)),
                                feature_scale)
        prev = z_corr * prev + (1 - z_corr) * innov
        img = prev + 0.15 * gaussian_filter(
            rng.standard_normal((height, width)), 1.5
        )
        img = (img - img.min()) / (np.ptp(img) + 1e-8)
        out.append((20 + img * 215).astype(np.uint8))
    return np.stack(out)
