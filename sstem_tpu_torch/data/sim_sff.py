"""SFF (support-film-fold) degradation synthesis (counterpart of
``sstem_tpu/data/sim_sff.py``: the host path, the offline simulator and the
batched device path).

  * ``degrade_sff`` — the train-time inline degradation
    (sff_scripts_unfolding/data/data_provider.py:180-245): a random fold line
    between two distinct borders, ``gen_flow_np``, the edge-clamped bilinear
    warp truncated to uint8, a black fold strip, the 400^2 -> 256^2 centre
    crop, resampled until the strip covers >= 100 zero pixels. Host numpy;
    it draws from the ``np.random.Generator`` in the JAX package's order, so
    one seed gives the same fold parameters.
  * ``SimuSFF`` — the offline simulator (simu_sff/simuSFF.py:14-144):
    endpoints >= size/2 apart, line width 5..20, an optional regional-contrast
    noise box; host numpy, with the same draws in the same order as the JAX
    package's (the crop offset, the fold, then the noise box).
  * ``degrade_sff_batch`` — the same degradation batched on the tensors'
    device: each image draws ``candidates`` fold parameter sets from an
    explicit ``torch.Generator``, all of them are synthesized in one batched
    pass (``gen_flow``, ``image_warp``), and the first candidate whose strip
    covers >= ``min_zero`` zero pixels of the crop is kept, else the one with
    the most. ``degrade_with_params`` is its deterministic part, at given
    fold parameters. torch generators cannot reproduce ``jax.random``, so the
    draws match the JAX package's only in their ranges.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

from sstem_tpu_torch.ops.flow import gen_flow, gen_flow_np, gen_line
from sstem_tpu_torch.ops.warp import image_warp


# ---------------------------------------------------------------------------
# Host (numpy) path
# ---------------------------------------------------------------------------

def _np_image_warp_bilinear(im, flow):
    """uint8-returning warp (reference image_warp semantics): the float32
    edge-clamped bilinear warp of ``im`` (H, W) by ``flow`` (H, W, 2),
    truncated to uint8."""
    out = image_warp(torch.from_numpy(im[None, :, :, None].astype(np.float32)),
                     torch.from_numpy(np.asarray(flow, np.float32)[None]),
                     "bilinear")[0, :, :, 0].numpy()
    return out.astype(np.uint8)


def _sample_endpoints(rng, height, width, min_dist=0.0):
    """Two random points on distinct borders, optionally >= min_dist apart.

    Border ids (flow_synthesis.py:99-133): 1 top (0,x), 2 right (x,width),
    3 bottom (height,x), 4 left (x,0); stored [row, col]."""
    while True:
        k1 = rng.integers(1, 5)
        k2 = rng.integers(1, 5)
        while k1 == k2:
            k2 = rng.integers(1, 5)

        def point(k):
            if k == 1:
                return [0, int(rng.integers(1, width))]
            if k == 2:
                return [int(rng.integers(1, height)), width]
            if k == 3:
                return [height, int(rng.integers(1, width))]
            return [int(rng.integers(1, height)), 0]

        p1, p2 = point(k1), point(k2)
        d = math.hypot(p1[0] - p2[0], p1[1] - p2[1])
        if d >= min_dist:
            return p1, p2


def sample_fold_params(rng, height, width, line_width_range=(5, 50),
                       fold_width_max=80, dis_k_range=(1e-5, 0.1),
                       min_endpoint_dist=0.0):
    """Random fold parameters (k, b, line_width, fold_width, dis_k)."""
    line_width = int(rng.integers(line_width_range[0], line_width_range[1] + 1))
    fold_width = int(rng.integers(line_width + 1, fold_width_max + 1))
    p1, p2 = _sample_endpoints(rng, height, width, min_endpoint_dist)
    dis_k = float(rng.uniform(*dis_k_range))
    k, b = gen_line(p1, p2)
    return dict(k=k, b=b, line_width=line_width, fold_width=fold_width,
                dis_k=dis_k)


def degrade_sff(img, rng, det_size=256, line_width_range=(5, 50),
                fold_width_max=80, min_zero=100, max_tries=1000):
    """Degrade one clean crop (H, W) uint8; returns a dict with the
    centre-cropped ``degraded``, ``flow`` (clean -> folded), ``flow2`` (the
    ground-truth unfolding flow), ``mask`` and ``params``. Resamples until
    the fold strip covers >= min_zero pixels of the centre crop
    (data_provider.py:236-241), with a bounded try count.
    """
    height, width = img.shape
    off = (height - det_size) // 2
    for _ in range(max_tries):
        p = sample_fold_params(rng, height, width, line_width_range,
                               fold_width_max)
        flow, flow2, mask = gen_flow_np(height, width, p["k"], p["b"],
                                        p["line_width"], p["fold_width"],
                                        p["dis_k"])
        deformed = _np_image_warp_bilinear(img, flow)
        deformed = (deformed * mask).astype(np.uint8)
        sl = slice(off, -off) if off else slice(None)
        deformed_c = deformed[sl, sl]
        if int((deformed_c == 0).sum()) >= min_zero:
            return dict(
                degraded=deformed_c,
                flow=flow[sl, sl],
                flow2=flow2[sl, sl].astype(np.float32),
                mask=mask[sl, sl],
                params=p,
            )
    raise RuntimeError("degrade_sff: no valid fold found")


@dataclass
class SimuSFF:
    """Offline SFF simulator (simu_sff/simuSFF.py parity).

    Usage: ``SimuSFF(size=1024)(img, rng)`` -> (degraded, flow, mask).
    Differences from the train-time path: endpoints must be >= size/2 apart
    (simuSFF.py:96-112), line_width 5..20, optional regional-contrast noise
    box 50..200 px with alpha U(0.4, 1.0) (simuSFF.py:132-144).
    """

    size: int = 1024
    apply_noise: bool = True
    min_zero: int = 100
    max_tries: int = 1000

    def __call__(self, img, rng):
        height = width = self.size
        if img.shape[0] < height or img.shape[1] < width:
            raise ValueError(f"SimuSFF: image {img.shape} is smaller than "
                             f"{self.size}^2")
        i = int(rng.integers(0, img.shape[0] - height + 1))
        j = int(rng.integers(0, img.shape[1] - width + 1))
        crop = img[i:i + height, j:j + width]

        for _ in range(self.max_tries):
            p = sample_fold_params(
                rng, height, width, line_width_range=(5, 20),
                fold_width_max=80, min_endpoint_dist=height / 2,
            )
            flow, _, mask = gen_flow_np(height, width, p["k"], p["b"],
                                        p["line_width"], p["fold_width"],
                                        p["dis_k"])
            deformed = _np_image_warp_bilinear(crop, flow)
            deformed = (deformed * mask).astype(np.uint8)
            if int((deformed == 0).sum()) >= self.min_zero:
                if self.apply_noise:
                    deformed = self.noise(deformed, rng)
                return deformed, flow, mask
        raise RuntimeError("SimuSFF: no valid fold found")

    def noise(self, img, rng):
        """Regional contrast box (simuSFF.py:132-144)."""
        img = img.astype(np.float32)
        mask = (img != 0).astype(np.float32)
        alpha = rng.uniform(0.4, 1.0)
        h = int(rng.integers(50, 201))
        w = int(rng.integers(50, 201))
        y = int(rng.integers(0, self.size - h + 1))
        x = int(rng.integers(0, self.size - w + 1))
        box = img[y:y + h, x:x + w]
        img[y:y + h, x:x + w] = alpha * (box - img.mean()) + img.mean()
        img = np.clip(img * mask, 0, 255)
        return img.astype(np.uint8)


# ---------------------------------------------------------------------------
# Device (torch) batched path
# ---------------------------------------------------------------------------

def step_generator(seed, step, device, stream=0):
    """A ``torch.Generator`` on ``device`` seeded from (seed, step, stream):
    the port's counterpart of ``jax.random.fold_in(PRNGKey(seed), step)``,
    so that a step's draws depend only on the run's seed and the step index
    (a resumed run continues the stream). ``stream`` keeps separate uses of
    one step apart (crop sampling and degradation)."""
    state = np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFF, int(step) & 0xFFFFFFFF, int(stream)])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state.generate_state(1, np.uint64)[0] >> 1))
    return gen


def sample_fold_params_batch(gen, n, height, width, line_width_range=(5, 50),
                             fold_width_max=80, dis_k_range=(1e-5, 0.1)):
    """``n`` fold parameter sets drawn from ``gen`` on its device: (k, b,
    line_width, fold_width, dis_k), each an (n,) float32 tensor, in the
    ranges of the host sampler (line width U{lo..hi}, fold width
    U{line_width+1..fold_width_max}, endpoints on two distinct borders,
    dis_k U(lo, hi))."""
    dev = gen.device

    def randint(lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev)

    line_width = randint(line_width_range[0], line_width_range[1] + 1)
    u = torch.rand(n, generator=gen, device=dev)
    fold_width = line_width + 1 + torch.floor(
        u * (fold_width_max - line_width).float()).long()
    b1 = randint(0, 4)
    b2 = (b1 + randint(1, 4)) % 4  # a distinct border

    def border_point(b):
        # borders 0..3 = top, right, bottom, left; returns (row, col)
        x_w = randint(1, width).float()
        x_h = randint(1, height).float()
        row = torch.where(b == 0, 0.0, torch.where(b == 2, float(height), x_h))
        col = torch.where(b == 1, float(width), torch.where(b == 3, 0.0, x_w))
        return row, col

    r1, c1 = border_point(b1)
    r2, c2 = border_point(b2)
    denom = torch.where(c2 - c1 == 0, 1e-9, c2 - c1)
    k = (r2 - r1) / denom
    b = r1 - k * c1
    dis_k = dis_k_range[0] + (dis_k_range[1] - dis_k_range[0]) * torch.rand(
        n, generator=gen, device=dev)
    return k, b, line_width.float(), fold_width.float(), dis_k


def degrade_with_params(images, params, det_size=256, min_zero=100):
    """The deterministic part of ``degrade_sff_batch``.

    Args:
      images: (B, H, W) clean crops on the 0..255 scale (uint8 or float).
      params: (k, b, line_width, fold_width, dis_k), each (B, R): R fold
        candidates per image.

    Returns (degraded (B, det, det) float32 in 0..255, flow2
    (B, det, det, 2)) of the first candidate whose strip covers >=
    ``min_zero`` zero pixels of the crop, else of the one with the most.
    """
    bsz, height, width = images.shape
    r = params[0].shape[1]
    off = (height - det_size) // 2
    sl = slice(off, off + det_size)
    flow, flow2, mask = gen_flow(height, width, *params)
    src = images.float()[:, None, :, :, None].expand(bsz, r, height, width, 1)
    warped = image_warp(src.reshape(bsz * r, height, width, 1),
                        flow.reshape(bsz * r, height, width, 2))
    # uint8 truncation, as the host path's astype(uint8)
    deformed = torch.floor(warped[..., 0].clamp(0, 255)).reshape(
        bsz, r, height, width) * mask
    deformed_c = deformed[..., sl, sl]
    counts = (deformed_c == 0).sum(dim=(-2, -1))
    valid = counts >= min_zero
    first = torch.argmax(valid.int(), dim=1)
    idx = torch.where(valid.any(dim=1), first, torch.argmax(counts, dim=1))
    rows = torch.arange(bsz, device=images.device)
    return deformed_c[rows, idx], flow2[rows, idx, sl, sl]


def degrade_sff_batch(images, gen, det_size=256, candidates=4,
                      line_width_range=(5, 50), fold_width_max=80,
                      dis_k_range=(1e-5, 0.1), min_zero=100, rank=0, world=1):
    """Batched SFF degradation on the images' device.

    Args:
      images: (B, H, W) float or uint8 clean crops (values 0..255).
      gen: ``torch.Generator`` on the images' device.
      det_size: centre-crop size of the returned degraded and label fields.
      candidates: fold parameter draws per image (a bounded replacement for
        the reference's unbounded retry loop).
      rank, world: ``images`` are rank ``rank``'s rows of a global batch of
        ``world * B`` (data parallelism). The parameters of the whole
        global batch are drawn (the draw couples the images), and this
        rank's rows applied, so the result is exactly those rows of the
        one-process degradation of the global batch.

    Returns degraded (B, det, det) float32 in 0..255, flow2 (B, det, det, 2).
    """
    bsz, height, width = images.shape
    params = sample_fold_params_batch(gen, world * bsz * candidates, height,
                                      width, line_width_range, fold_width_max,
                                      dis_k_range)
    params = [p.reshape(world * bsz, candidates)[rank * bsz:(rank + 1) * bsz]
              for p in params]
    return degrade_with_params(images, params, det_size, min_zero)
