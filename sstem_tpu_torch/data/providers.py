"""Interp training data (counterpart of ``sstem_tpu/data/providers.py``:
``AugConfig``, ``_ImageCache``, ``InterpTrainDataset``,
``InterpValidDataset`` and ``Provider``).

  * ``InterpTrainDataset`` — triplet txt reader, random crop, joint dihedral
    augs, optional frame swap / jitter / gaussian noise / elastic transform
    (sff_scripts_interp/data/data_provider.py:93-157). A sample is the input
    (6, H, W) = [i1 x3 ++ i3 x3] / 255 and the label (1, H, W) = middle
    section / 255, channels first (the JAX package returns the same arrays
    channels last). It draws from the numpy RNG in the JAX package's order,
    so one seed gives the same samples.
  * ``InterpValidDataset`` — map-style triplets, channels first.
  * ``Provider`` — an infinite batched stream from background threads. Each
    thread t draws from ``np.random.default_rng(seed + t)``, so with one
    thread the batches are the JAX provider's. ``next()`` returns NCHW
    tensors on the trainer's device, copied from pinned host memory with
    ``non_blocking`` when the device is a CUDA card.
"""

import os
import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from sstem_tpu_torch.data import augment


def _read_gray(path):
    from PIL import Image

    return np.asarray(Image.open(path))


@dataclass
class AugConfig:
    random_fliplr: bool = True
    random_flipud: bool = True
    random_flipz: bool = True   # transpose
    random_rotation: bool = True
    swap: bool = False
    color_jitter: bool = False
    brightness: float = 0.2
    contrast: float = 0.2
    saturation: float = 0.2
    gauss_noise: bool = False
    gauss_mean: float = 0.0
    gauss_sigma: float = 0.001
    elastic_trans: bool = False
    alpha_range: float = 100.0
    sigma: float = 10.0
    shave: int = 20


class _ImageCache:
    """Loads listed images once; CREMI-scale data fits host RAM easily."""

    def __init__(self, folder):
        self.folder = folder
        self._cache = {}

    def __call__(self, name):
        if name not in self._cache:
            self._cache[name] = _read_gray(os.path.join(self.folder, name))
        return self._cache[name]


def _read_rows(folder, txt):
    with open(os.path.join(folder, txt)) as f:
        return [r.strip().split(" ") for r in f if r.strip()]


class InterpTrainDataset:
    """SFF interpolation triplets -> ((6,H,W) input, (1,H,W) label)."""

    def __init__(self, folder, train_txt="train_data.txt",
                 patch_size=(256, 256), aug: AugConfig = None):
        self.cache = _ImageCache(folder)
        self.rows = _read_rows(folder, train_txt)
        self.patch_size = tuple(patch_size)
        self.aug = aug or AugConfig()

    def sample(self, rng):
        a = self.aug
        row = self.rows[rng.integers(0, len(self.rows))]
        imgs = [self.cache(n) for n in row[:3]]
        h, w = imgs[0].shape
        ch, cw = self.patch_size
        i = rng.integers(0, h - ch + 1)
        j = rng.integers(0, w - cw + 1)
        stack = np.stack([im[i:i + ch, j:j + cw] for im in imgs])

        stack = augment.dihedral(stack, rng, a.random_fliplr, a.random_flipud,
                                 a.random_flipz, a.random_rotation)
        if a.swap:
            stack = augment.swap_frames(stack, rng)
        if a.color_jitter:
            stack = np.stack([
                augment.color_jitter(s, rng, a.brightness, a.contrast,
                                     a.saturation) for s in stack
            ])

        im = np.concatenate([
            np.repeat(stack[0:1], 3, 0), np.repeat(stack[2:3], 3, 0)
        ]).astype(np.float32) / 255.0
        lb = stack[1:2].astype(np.float32) / 255.0
        if a.gauss_noise:
            im = augment.gauss_noise(im, rng, a.gauss_mean, a.gauss_sigma)
        if a.elastic_trans:
            im, lb = augment.elastic_transform(im, lb, rng, a.alpha_range,
                                               a.sigma, a.shave)
        return im, lb


class InterpValidDataset:
    """Map-style triplets -> ((6,H,W), (1,H,W))."""

    def __init__(self, folder, valid_txt="valid_data.txt"):
        self.cache = _ImageCache(folder)
        self.rows = _read_rows(folder, valid_txt)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx):
        imgs = [self.cache(n).astype(np.float32) / 255.0
                for n in self.rows[idx][:3]]
        im = np.stack([imgs[0]] * 3 + [imgs[2]] * 3)
        lb = imgs[1][None]
        return im, lb


class Provider:
    """Infinite batched stream with background prefetch -> device tensors.

    API parity with the reference Provider (data_provider.py:289-336):
    ``Provider(dataset, batch_size).next()`` returns the next batch, a tuple
    of (B, ...) tensors on ``device``, from samples that are tuples of
    arrays.
    """

    def __init__(self, dataset, batch_size, seed=555, num_threads=2,
                 prefetch=4, device="cpu"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self._q = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._threads = []
        for t in range(max(1, num_threads)):
            rng = np.random.default_rng(None if seed in (-1, None) else seed + t)
            th = threading.Thread(target=self._worker, args=(rng,), daemon=True)
            th.start()
            self._threads.append(th)

    def _worker(self, rng):
        while not self._stop.is_set():
            samples = [self.dataset.sample(rng) for _ in range(self.batch_size)]
            batch = tuple(np.stack(xs) for xs in zip(*samples))
            # retry the SAME batch on backpressure: rebuilding it costs host CPU
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=1.0)
                    break
                except queue.Full:
                    continue

    def next(self):
        batch = tuple(torch.from_numpy(a) for a in self._q.get())
        if self.device.type == "cuda":
            # a fresh pinned buffer per batch: the caching host allocator
            # keeps it until the asynchronous copy has finished
            return tuple(t.pin_memory().to(self.device, non_blocking=True)
                         for t in batch)
        return tuple(t.to(self.device) for t in batch)

    def close(self):
        self._stop.set()
        for th in self._threads:
            th.join(timeout=5.0)
