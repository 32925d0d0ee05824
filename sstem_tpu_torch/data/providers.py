"""Training and validation data (counterpart of
``sstem_tpu/data/providers.py``: ``AugConfig``, ``_ImageCache``,
``_load_pool``, the interp, unfolding, fusion and SP datasets, and
``Provider``).

  * ``InterpTrainDataset`` — triplet txt reader, random crop, joint dihedral
    augs, optional frame swap / jitter / gaussian noise / elastic transform
    (sff_scripts_interp/data/data_provider.py:93-157). A sample is the input
    (6, H, W) = [i1 x3 ++ i3 x3] / 255 and the label (1, H, W) = middle
    section / 255, channels first (the JAX package returns the same arrays
    channels last). It draws from the numpy RNG in the JAX package's order,
    so one seed gives the same samples.
  * ``InterpValidDataset`` — map-style triplets, channels first.
  * ``UnfoldingTrainDataset`` — a clean section and its interp image,
    degraded on the fly (``sim_sff.degrade_sff``): a 400^2 crop centre-cropped
    to 256^2; the label is the ground-truth unfolding flow (2, H, W)
    (sff_scripts_unfolding/data/data_provider.py:105-175), or with
    ``label='clean'`` the clean crop (1, H, W) / 255 (``FusionTrainDataset``,
    line width 5..20, sff_scripts_fusion/data/data_provider.py:163-185).
  * ``RawCropPairDataset`` — (clean, interp) uint8 crop pairs for the
    trainers' ``--device-datagen`` path; ``load_pool`` stacks the whole set
    as (N, 2, H, W) uint8 for a pool resident on the card.
  * ``UnfoldingValidDataset`` (flow2 from ``<name>_flow.hdf`` sidecars,
    read with h5py, which is imported only there) and
    ``FusionValidDataset`` (clean ground truth), map-style.
  * ``SPDataset`` — SP quartet rows (``write_sp_txt``'s 12 columns): a
    dict of (1, H, W) float crops in 0..1 under ``_SP_KEYS``, masks a and b
    each with its reversal ``255 - m``, a joint 8-way dihedral and color
    jitter on the degraded frames (sp_scripts_train/data/dataset.py).
  * ``Provider`` — an infinite batched stream from background threads. Each
    thread t draws from ``np.random.default_rng(seed + t)``, so with one
    thread the batches are the JAX provider's. Samples are tuples or dicts
    of arrays; ``next()`` returns a tuple or dict of NCHW tensors on the
    trainer's device, copied from pinned host memory with ``non_blocking``
    when the device is a CUDA card. Under data parallelism
    (``rank``/``world``) it draws the same global batches on every rank
    and keeps this rank's rows.
"""

import os
import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from sstem_tpu_torch.data import augment
from sstem_tpu_torch.data.sim_sff import degrade_sff
from sstem_tpu_torch.parallel.ddp import local_batch_size, rank_rows, shared_seed


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


def _load_pool(cache, name_rows, max_bytes):
    """Stack rows of image names into (N, F, H, W) uint8, or None when the
    shapes are non-uniform or the pool would exceed ``max_bytes``."""
    shapes = {cache(n).shape for row in name_rows for n in row}
    if len(shapes) != 1:
        return None
    (h, w), = shapes
    f = len(name_rows[0])
    if len(name_rows) * f * h * w > max_bytes:
        return None
    return np.stack([np.stack([cache(n) for n in row])
                     for row in name_rows])


class InterpTrainDataset:
    """SFF interpolation triplets -> ((6,H,W) input, (1,H,W) label)."""

    def __init__(self, folder, train_txt="train_data.txt",
                 patch_size=(256, 256), aug: AugConfig = None):
        self.cache = _ImageCache(folder)
        self.rows = _read_rows(folder, train_txt)
        self.patch_size = tuple(patch_size)
        self.aug = aug or AugConfig()

    def load_pool(self, max_bytes=512 << 20):
        """All triplets as one (N, 3, H, W) uint8 array for the trainer's
        pool on the card (``train.device_datagen.make_pool_interp_step``),
        or None when the images are non-uniform or the pool exceeds
        ``max_bytes``."""
        return _load_pool(self.cache, [r[:3] for r in self.rows], max_bytes)

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


class _CleanInterpPairs:
    """Rows of a triplet list whose middle section is the clean image, each
    paired with the interp image of the same row from ``interp_txt``."""

    def __init__(self, folder, train_txt, interp_txt, crop_size, aug):
        self.cache = _ImageCache(folder)
        self.rows = _read_rows(folder, train_txt)
        with open(os.path.join(folder, interp_txt)) as f:
            self.interp_rows = [r.strip() for r in f if r.strip()]
        assert len(self.rows) == len(self.interp_rows)
        self.crop_size = crop_size
        self.aug = aug or AugConfig()

    def _crop_pair(self, rng):
        """A random (2, c, c) [clean, interp] crop with the joint dihedral
        augmentations, drawn in the JAX package's order."""
        a = self.aug
        kk = rng.integers(0, len(self.rows))
        # the middle column of the triplet row is the section the interp
        # image predicts
        clean = self.cache(self.rows[kk][1])
        interp = self.cache(self.interp_rows[kk])
        c = self.crop_size
        h, w = clean.shape
        i = rng.integers(0, h - c + 1)
        j = rng.integers(0, w - c + 1)
        stack = np.stack([clean[i:i + c, j:j + c], interp[i:i + c, j:j + c]])
        return augment.dihedral(stack, rng, a.random_fliplr, a.random_flipud,
                                a.random_flipz, a.random_rotation)


class UnfoldingTrainDataset(_CleanInterpPairs):
    """Clean + interp pairs degraded on the fly -> ((6, det, det) input
    [degraded x3 ++ interp x3] / 255, label).

    label='flow'  -> the ground-truth unfolding flow2 (2, det, det)
                     [unfolding trainer]
    label='clean' -> the clean centre crop (1, det, det) / 255
                     [fusion trainer]
    The reference's 'swap' aug at this layer indexes a frame that does not
    exist (im_lb[2]); configs ship swap=False and it is not re-created.
    """

    def __init__(self, folder, train_txt, interp_txt, crop_size=400,
                 det_size=256, label="flow", line_width_range=(5, 50),
                 gt_line=False, aug: AugConfig = None):
        super().__init__(folder, train_txt, interp_txt, crop_size, aug)
        self.det_size = det_size
        self.offset = (crop_size - det_size) // 2
        self.label = label
        self.line_width_range = line_width_range
        self.gt_line = gt_line

    def sample(self, rng):
        a = self.aug
        stack = self._crop_pair(rng)
        img2 = stack[0]
        if a.color_jitter:
            img2 = augment.color_jitter(img2, rng, a.brightness, a.contrast,
                                        a.saturation)
        off = self.offset
        clean_c = img2[off:-off, off:-off].copy()

        d = degrade_sff(img2, rng, det_size=self.det_size,
                        line_width_range=self.line_width_range)
        degraded = d["degraded"]
        if self.gt_line:
            clean_c = clean_c * (degraded != 0)

        interp_c = stack[1][off:-off, off:-off]
        im = np.concatenate([
            np.repeat(degraded[None], 3, 0), np.repeat(interp_c[None], 3, 0)
        ]).astype(np.float32) / 255.0
        if self.label == "flow":
            lb = np.ascontiguousarray(d["flow2"].transpose(2, 0, 1))
        else:
            lb = (clean_c.astype(np.float32) / 255.0)[None]
        return im, lb


class FusionTrainDataset(UnfoldingTrainDataset):
    """Fusion trainer dataset: clean-crop labels, line width 5..20."""

    def __init__(self, folder, train_txt, interp_txt, **kw):
        kw.setdefault("label", "clean")
        kw.setdefault("line_width_range", (5, 20))
        super().__init__(folder, train_txt, interp_txt, **kw)


class RawCropPairDataset(_CleanInterpPairs):
    """(clean crop, interp crop) uint8 pairs for the trainers'
    ``--device-datagen`` path (``train.device_datagen``): the host only crops
    and augments; the degradation and the labels are made on the card."""

    def __init__(self, folder, train_txt, interp_txt, crop_size=400,
                 aug: AugConfig = None):
        super().__init__(folder, train_txt, interp_txt, crop_size, aug)

    def load_pool(self, max_bytes=512 << 20):
        """(N, 2, H, W) uint8 clean+interp pool for sampling on the card
        (``train.device_datagen.make_pool_step``), or None when the images
        are non-uniform or the pool exceeds ``max_bytes``."""
        rows = [[r[1], i] for r, i in zip(self.rows, self.interp_rows)]
        return _load_pool(self.cache, rows, max_bytes)

    def sample(self, rng):
        stack = self._crop_pair(rng)
        return np.ascontiguousarray(stack[0]), np.ascontiguousarray(stack[1])


def _gray6(deg, interp):
    """Two uint8 (H, W) images -> (6, H, W) float32 [deg x3 ++ interp x3] /
    255."""
    return np.stack([deg.astype(np.float32) / 255.0] * 3
                    + [interp.astype(np.float32) / 255.0] * 3)


class UnfoldingValidDataset:
    """Degraded + interp images with the ground-truth flow2 from HDF5
    sidecars -> ((6, H, W), (2, H, W)).

    Row format: '<degraded.png> <interp.png> <name>_flow.hdf'; the HDF file
    holds dataset 'flow2' (H, W, 2) (provider_valid.py:27-54)."""

    def __init__(self, folder, valid_txt):
        self.folder = folder
        self.rows = _read_rows(folder, valid_txt)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx):
        import h5py

        row = self.rows[idx]
        deg = _read_gray(os.path.join(self.folder, row[0]))
        interp = _read_gray(os.path.join(self.folder, row[1]))
        with h5py.File(os.path.join(self.folder, row[2]), "r") as f:
            flow2 = np.asarray(f["flow2"], np.float32)
        return _gray6(deg, interp), np.ascontiguousarray(flow2.transpose(2, 0, 1))


class FusionValidDataset:
    """Degraded + interp + clean ground-truth rows -> ((6, H, W),
    (1, H, W))."""

    def __init__(self, folder, valid_txt):
        self.folder = folder
        self.rows = _read_rows(folder, valid_txt)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx):
        deg, interp, clean = (_read_gray(os.path.join(self.folder, n))
                              for n in self.rows[idx][:3])
        return _gray6(deg, interp), (clean.astype(np.float32) / 255.0)[None]


_SP_KEYS = [
    "img_1", "img_2", "img_2_degra", "img_3", "img_3_degra", "img_4",
    "img_2_degraB1_mask_gradall", "img_3_degraB1_mask_gradall",
    "img_2_degraB1_mask_gradall_r", "img_3_degraB1_mask_gradall_r",
    "img_2_degraB1_GenGradMask", "img_3_degraB1_GenGradMask",
    "img_2_degraB1_GenGradMask_r", "img_3_degraB1_GenGradMask_r",
    "img_2_degraB1_vfi", "img_3_degraB1_vfi",
]


def write_sp_txt(folder, num, path="sp_train_data.txt"):
    """12-column SP row writer (gen_data_txt.py dialect)."""
    with open(os.path.join(folder, path), "w") as f:
        for i in range(1, num + 1):
            stem = str(i).zfill(4)
            cols = [f"{stem}_1.png", f"{stem}_2.png", f"{stem}_2_degra.png",
                    f"{stem}_3.png", f"{stem}_3_degra.png", f"{stem}_4.png",
                    f"{stem}_2_degra_maska.png", f"{stem}_3_degra_maska.png",
                    f"{stem}_2_degra_maskb.png", f"{stem}_3_degra_maskb.png",
                    f"{stem}_2_interp.png", f"{stem}_3_interp.png"]
            f.write(" ".join(cols) + " \n")


class SPDataset:
    """SP quartet dataset -> dict of (1, H, W) float32 arrays in [0, 1].

    Column order per row: clean 1/2, degraded 2, clean 3, degraded 3, clean
    4, grad masks (a) for 2/3, generated masks (b) for 2/3 [, vfi 2/3].
    ``data_txt`` is a path (not joined with ``data_folder``), as in the JAX
    trainers. It draws from the numpy RNG in the JAX package's order: the
    crop's row and column, the dihedral case, then per degraded frame the
    jitter's coin and factors."""

    def __init__(self, data_folder, data_txt, patch_size=256, if_rotate=True,
                 if_bdadjust=True, use_vfi=False):
        self.folder = data_folder
        with open(data_txt) as f:
            self.rows = [r.strip().split(" ") for r in f if r.strip()]
        self.rows = [[c for c in row if c] for row in self.rows]
        self.patch_size = patch_size
        self.if_rotate = if_rotate
        self.if_bdadjust = if_bdadjust
        self.use_vfi = use_vfi
        self.cache = _ImageCache(data_folder)

    def __len__(self):
        return len(self.rows)

    def _load_row(self, idx):
        row = self.rows[idx]
        imgs = [self.cache(row[i]) for i in range(6)]
        maska = [self.cache(row[6]), self.cache(row[7])]
        maskb = [self.cache(row[8]), self.cache(row[9])]
        out = imgs + maska + [255 - m for m in maska] + maskb + [
            255 - m for m in maskb
        ]
        if self.use_vfi:
            out += [self.cache(row[10]), self.cache(row[11])]
        return out

    def get(self, idx, rng):
        imgs = self._load_row(idx)
        h, w = imgs[0].shape[:2]
        p = self.patch_size
        i = rng.integers(0, h - p + 1)
        j = rng.integers(0, w - p + 1)
        imgs = [im[i:i + p, j:j + p] for im in imgs]

        if self.if_rotate:
            case = rng.integers(0, 8)
            # 8-way dihedral: rot90 x {0..3} (+ fliplr), RotationFlip parity
            imgs = [np.rot90(im, case // 2) for im in imgs]
            if case % 2:
                imgs = [np.fliplr(im) for im in imgs]

        out = {}
        for k, im in zip(_SP_KEYS, imgs):
            if self.if_bdadjust and k in ("img_2_degra", "img_3_degra") and \
                    rng.uniform() > 0.7:
                im = augment.color_jitter(np.ascontiguousarray(im), rng,
                                          0.2, 0.2, 0.2)
            out[k] = (np.ascontiguousarray(im).astype(np.float32) / 255.0)[None]
        return out

    def sample(self, rng):
        return self.get(rng.integers(0, len(self.rows)), rng)

    @staticmethod
    def dilate_mask(mask, thickness):
        """cv2 dilation (reference DilateMask, dataset.py:238-243; unused by
        the reference trainers)."""
        import cv2

        k = np.ones((thickness, thickness), np.uint8)
        return cv2.dilate(np.asarray(mask), k, iterations=1)

    @staticmethod
    def erode_mask(mask, thickness):
        """cv2 erosion (reference ErodeMask, dataset.py:245-250)."""
        import cv2

        k = np.ones((thickness, thickness), np.uint8)
        return cv2.erode(np.asarray(mask), k, iterations=1)


class Provider:
    """Infinite batched stream with background prefetch -> device tensors.

    API parity with the reference Provider (data_provider.py:289-336):
    ``Provider(dataset, batch_size).next()`` returns the next batch on
    ``device``: a tuple of (B, ...) tensors from samples that are tuples of
    arrays, or a dict of them from samples that are dicts.

    Data parallelism: with ``world`` > 1 ``batch_size`` is the global
    batch, which must divide among the ranks, and ``next()`` returns rank
    ``rank``'s rows of it (``parallel.ddp.rank_rows``). Every rank draws
    the whole global batch from the same streams (an unseeded provider
    takes a seed broadcast from rank 0), so each rank does the host work of
    all ranks; with ``num_threads=1`` a rank's rows are exactly the
    one-process provider's rows of the same batch. Each thread then has a
    queue of its own, taken in turn, so that every rank takes the same
    global batch at each step; with one rank the threads share one queue,
    the first batch ready going first.
    """

    def __init__(self, dataset, batch_size, seed=555, num_threads=2,
                 prefetch=4, device="cpu", rank=0, world=1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.rank, self.world = rank, world
        local_batch_size(batch_size, world)
        if world > 1:
            seed = shared_seed(seed)
        n = max(1, num_threads)
        shared = queue.Queue(maxsize=prefetch)
        self._queues = ([queue.Queue(maxsize=prefetch) for _ in range(n)]
                        if world > 1 else [shared] * n)
        self._turn = 0
        self._stop = threading.Event()
        self._threads = []
        for t in range(n):
            rng = np.random.default_rng(None if seed in (-1, None) else seed + t)
            th = threading.Thread(target=self._worker,
                                  args=(rng, self._queues[t]), daemon=True)
            th.start()
            self._threads.append(th)

    def _worker(self, rng, q):
        while not self._stop.is_set():
            samples = [self.dataset.sample(rng) for _ in range(self.batch_size)]
            if isinstance(samples[0], dict):
                batch = {k: np.stack([s[k] for s in samples])
                         for k in samples[0]}
            else:
                batch = tuple(np.stack(xs) for xs in zip(*samples))
            batch = rank_rows(batch, self.rank, self.world)
            # retry the SAME batch on backpressure: rebuilding it costs host CPU
            while not self._stop.is_set():
                try:
                    q.put(batch, timeout=1.0)
                    break
                except queue.Full:
                    continue

    def _to_device(self, a):
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            # a fresh pinned buffer per batch: the caching host allocator
            # keeps it until the asynchronous copy has finished
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def next(self):
        batch = self._queues[self._turn].get()
        self._turn = (self._turn + 1) % len(self._queues)
        if isinstance(batch, dict):
            return {k: self._to_device(a) for k, a in batch.items()}
        return tuple(self._to_device(a) for a in batch)

    def close(self):
        self._stop.set()
        # a worker blocked on a full queue puts its batch and sees the stop
        for q in set(self._queues):
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        for th in self._threads:
            th.join(timeout=5.0)
