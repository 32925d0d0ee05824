"""Synthetic ssTEM-like data (counterpart of ``sstem_tpu/data/synthetic.py``:
``synth_stack`` and ``write_triplet_tree``), numpy, scipy and Pillow.

Band-limited noise textures with strong z-correlation, so adjacent sections
look alike as in a real serial-section stack. The same seed gives the same
stack, and the same triplet tree, as the JAX package's functions.
"""

import os

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


def write_triplet_tree(root, n_triplets=4, size=320, seed=0):
    """Write an interp-style data tree: ``%04d_{1,2,3}.png`` plus
    ``train_data.txt`` rows '0000_1.png 0000_2.png 0000_3.png'
    (gen_data_txt.py dialect)."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    rows = []
    stack = synth_stack(n_triplets + 2, size, size, seed)
    for i in range(n_triplets):
        names = []
        for j in range(3):
            name = f"{i:04d}_{j + 1}.png"
            Image.fromarray(stack[i + j]).save(os.path.join(root, name))
            names.append(name)
        rows.append(" ".join(names))
    with open(os.path.join(root, "train_data.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
    return rows
