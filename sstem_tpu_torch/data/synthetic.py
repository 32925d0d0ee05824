"""Synthetic ssTEM-like data (counterpart of ``sstem_tpu/data/synthetic.py``:
``synth_stack``, ``write_triplet_tree`` and ``synth_blob_mask``), numpy,
scipy and Pillow; ``write_quartet_tree`` writes an SP training tree from
them.

Band-limited noise textures with strong z-correlation, so adjacent sections
look alike as in a real serial-section stack. The same seed gives the same
stack, and the same triplet tree and blob mask, as the JAX package's
functions.
"""

import os

import numpy as np


def synth_stack(n_sections=8, height=512, width=512, seed=0,
                z_corr=0.9, feature_scale=6.0):
    """(Z, H, W) uint8 stack of correlated textures."""
    from scipy.ndimage import gaussian_filter  # slow import

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


def synth_blob_mask(height=256, width=256, seed=0, n_blobs=1, rmin=20, rmax=60):
    """Random filled blob mask (uint8 0/255): a stand-in for the SP mask
    bank."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    mask = np.zeros((height, width), bool)
    for _ in range(n_blobs):
        cy = rng.integers(rmax, height - rmax)
        cx = rng.integers(rmax, width - rmax)
        r = rng.integers(rmin, rmax)
        # wobbly radius via low-frequency angular noise
        theta = np.arctan2(yy - cy, xx - cx)
        wobble = sum(
            rng.uniform(0.05, 0.25) * np.cos(k * theta + rng.uniform(0, 2 * np.pi))
            for k in range(2, 5)
        )
        rr = r * (1 + wobble)
        mask |= (yy - cy) ** 2 + (xx - cx) ** 2 <= rr**2
    return (mask * 255).astype(np.uint8)


def write_quartet_tree(root, n_quartets=4, size=256, seed=0):
    """Write an SP training tree: for row i, sections ``%04d_{1,2,3,4}.png``
    of a ``synth_stack``, sections 2 and 3 darkened inside
    ``synth_blob_mask`` blobs (``_{2,3}_degra.png``), those blobs as mask a
    and, grown by 3 pixels, as mask b (``_{2,3}_degra_mask{a,b}.png``), and
    the mean of sections 1 and 4 as both interp images
    (``_{2,3}_interp.png``); then ``sp_train_data.txt`` in
    ``providers.write_sp_txt``'s 12 columns. Returns the txt's path."""
    from PIL import Image
    from scipy.ndimage import binary_dilation

    from sstem_tpu_torch.data.providers import write_sp_txt

    os.makedirs(root, exist_ok=True)
    stack = synth_stack(n_quartets + 3, size, size, seed)
    r = max(size // 16, 4)
    for i in range(n_quartets):
        stem = str(i + 1).zfill(4)
        images = {f"{stem}_{j + 1}.png": stack[i + j] for j in range(4)}
        interp = ((stack[i].astype(np.uint16) + stack[i + 3]) // 2)
        for j in (2, 3):
            blob = synth_blob_mask(size, size, seed=seed * 1000 + 2 * i + j,
                                   n_blobs=3, rmin=r, rmax=2 * r) > 0
            clean = stack[i + j - 1].astype(np.float32)
            images[f"{stem}_{j}_degra.png"] = np.where(
                blob, clean * 0.35, clean).astype(np.uint8)
            images[f"{stem}_{j}_degra_maska.png"] = blob.astype(np.uint8) * 255
            images[f"{stem}_{j}_degra_maskb.png"] = binary_dilation(
                blob, iterations=3).astype(np.uint8) * 255
            images[f"{stem}_{j}_interp.png"] = interp.astype(np.uint8)
        for name, img in images.items():
            Image.fromarray(img).save(os.path.join(root, name))
    write_sp_txt(root, n_quartets)
    return os.path.join(root, "sp_train_data.txt")
