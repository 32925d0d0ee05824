"""Train-time augmentations (counterpart of ``sstem_tpu/data/augment.py``:
``dihedral``, ``swap_frames``, ``color_jitter``, ``gauss_noise`` and
``elastic_transform``), host numpy and scipy, applied before the copy to the
card. The same RNG stream gives the same result as the JAX package's.

Semantics from the reference providers
(sff_scripts_interp/data/data_provider.py:114-131,196-287):
  * joint dihedral augs over a (Z, H, W) stack: fliplr / flipud / transpose
    ('flipz' in the reference config names) / rot90 x k
  * frame-order swap (first <-> last section)
  * color jitter (brightness/contrast like torchvision ColorJitter on gray)
  * additive Gaussian noise with clip + uint8 round-trip
  * Simard elastic transform (Gaussian-filtered displacement, bilinear
    map_coordinates, border shave)
"""

import numpy as np


def dihedral(stack, rng, fliplr=True, flipud=True, transpose=True, rot=True):
    """Joint random dihedral transform over (Z, H, W) (square images)."""
    if fliplr and rng.uniform() < 0.5:
        stack = stack[:, :, ::-1]
    if flipud and rng.uniform() < 0.5:
        stack = stack[:, ::-1, :]
    if transpose and rng.uniform() < 0.5:
        stack = np.transpose(stack, (0, 2, 1))
    if rot:
        r = rng.integers(0, 4)
        stack = np.rot90(stack, r, axes=(1, 2))
    return np.ascontiguousarray(stack)


def swap_frames(stack, rng, prob=0.5):
    """Swap first/last frames (the 'swap' aug, data_provider.py:127-130)."""
    if rng.uniform() < prob:
        stack = stack.copy()
        stack[[0, -1]] = stack[[-1, 0]]
    return stack


def color_jitter(img, rng, brightness=0.2, contrast=0.2, saturation=0.2):
    """torchvision-style ColorJitter on a grayscale uint8 image.

    Brightness: x * U(1-b, 1+b); contrast: blend with the mean by
    U(1-c, 1+c); saturation is a no-op for grayscale. Factor order is
    randomized as in torchvision.
    """
    img = img.astype(np.float32)
    ops = []
    if brightness:
        f = rng.uniform(max(0, 1 - brightness), 1 + brightness)
        ops.append(lambda x: x * f)
    if contrast:
        g = rng.uniform(max(0, 1 - contrast), 1 + contrast)
        ops.append(lambda x: g * x + (1 - g) * x.mean())
    rng.shuffle(ops)
    for op in ops:
        img = op(img)
    return np.clip(img, 0, 255).astype(np.uint8)


def gauss_noise(img01, rng, mean=0.0, sigma=0.001):
    """Additive Gaussian noise on a [0,1] float image; uint8 round-trip as in
    the reference (_gauss_noise, data_provider.py:232-243 — note it uses
    sigma**0.5 as the std)."""
    noise = rng.normal(mean, sigma**0.5, img01.shape)
    out = img01 + noise
    low = -1.0 if out.min() < 0 else 0.0
    out = np.clip(out, low, 1.0)
    return (out * 255).astype(np.uint8).astype(np.float32) / 255.0


def elastic_transform(images, labels, rng, alpha_range=100.0, sigma=10.0,
                      shave=20):
    """Simard-style joint elastic deformation of (C,H,W) images and labels.

    Returns border-shaved arrays ((C, H-2s, W-2s))."""
    from scipy.ndimage import gaussian_filter, map_coordinates  # slow import

    alpha = rng.uniform(0, alpha_range)
    shape = images.shape[1:]
    dx = gaussian_filter(rng.uniform(size=shape) * 2 - 1, sigma,
                         mode="constant", cval=0) * alpha
    dy = gaussian_filter(rng.uniform(size=shape) * 2 - 1, sigma,
                         mode="constant", cval=0) * alpha
    x, y = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]), indexing="ij")
    idx = (np.reshape(x + dx, (-1, 1)), np.reshape(y + dy, (-1, 1)))

    def warp_stack(stack):
        out = [map_coordinates(ch, idx, order=1).reshape(shape) for ch in stack]
        return np.stack(out, axis=0)

    images = warp_stack(images)
    labels = warp_stack(labels)
    s = shave
    if s:
        images = images[:, s:-s, s:-s]
        labels = labels[:, s:-s, s:-s]
    return images, labels
