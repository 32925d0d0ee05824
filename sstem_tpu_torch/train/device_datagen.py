"""Degradation and crop sampling inside the training step (counterpart of
``sstem_tpu/train/device_datagen.py``).

The reference degrades inside DataLoader workers on the CPU
(sff_scripts_unfolding/data/data_provider.py:180-245), a numpy warp per
sample per step. Here the fold synthesis, the warp and the flow labels run
on the model's device inside the step (``data.sim_sff.degrade_sff_batch``),
from raw (clean, interp) uint8 crops. With a pool, the whole training set
lives on the card as one uint8 tensor and the crops (with the dihedral
augmentations) are sampled there too: the host streams only the step
counter (``CounterProvider``).

Every draw comes from a ``torch.Generator`` on the device seeded from the
run's seed and the step index (``sim_sff.step_generator``), as the JAX
package folds the step into its key, so a resumed run continues the stream.
The loss functions take ``(model, batch)`` as ``train.trainer.make_train_step``
calls them; the model is not an argument of the factories. The pool steps
run in one process only, as the JAX package's do: under a process group
the trainers stream raw crops from the host and degrade them here
(``degraded_batch``).
"""

import itertools

import torch

from sstem_tpu_torch import losses
from sstem_tpu_torch.data.sim_sff import degrade_sff_batch, step_generator
from sstem_tpu_torch.parallel import ddp
from sstem_tpu_torch.train.trainer import make_train_step

# the generator streams of one step (the JAX package's key salts)
DEGRADE_STREAM, POOL_STREAM, INTERP_POOL_STREAM = 0, 1, 2


def degraded_batch(clean, interp, step_idx, seed=0, det_size=256,
                   line_width_range=(5, 50)):
    """Degrade a (B, c, c) batch of clean crops on their device (4 fold
    candidates an image, ``degrade_sff_batch``'s default, as the JAX step).

    Under a process group ``clean`` and ``interp`` are this rank's rows of
    the global batch, and the result is exactly those rows of the
    one-process degradation of the global batch: every rank draws the
    global batch's fold parameters from the step's generator and applies
    its rows' (``degrade_sff_batch(rank=, world=)``).

    Returns inputs (B, 6, det, det) [degraded x3 ++ interp x3] / 255, the
    ground-truth unfolding flow (B, 2, det, det) and the clean centre crop
    (B, 1, det, det) / 255, all float32.
    """
    gen = step_generator(seed, step_idx, clean.device, DEGRADE_STREAM)
    degraded, flow2 = degrade_sff_batch(
        clean, gen, det_size=det_size, line_width_range=line_width_range,
        rank=ddp.rank(), world=ddp.world_size())
    off = (clean.shape[1] - det_size) // 2
    sl = slice(off, off + det_size)
    interp_c = interp[:, sl, sl].float() / 255.0
    deg = degraded / 255.0
    inputs = torch.stack([deg, deg, deg, interp_c, interp_c, interp_c], dim=1)
    target = (clean[:, sl, sl].float() / 255.0)[:, None]
    return inputs, flow2.permute(0, 3, 1, 2), target


def make_device_datagen_loss(det_size=256, seed=0):
    """The unfolding trainer's loss for (clean, interp, step_idx) batches of
    uint8 crops, the degradation inside: L1 on the ground-truth unfolding
    flow. A train step over such batches is ``make_train_step`` of it."""

    def loss_fn(model, batch):
        clean, interp, step_idx = batch
        inputs, flow2, _ = degraded_batch(clean, interp, step_idx, seed,
                                          det_size)
        return losses.l1_loss(model(inputs), flow2), {}

    return loss_fn


# ---------------------------------------------------------------------------
# Crop sampling from a pool resident on the card
# ---------------------------------------------------------------------------

def _dihedral(img, r):
    """One of the 8 dihedral transforms of a square (..., H, W) tensor, r in
    0..7: rot90 by r % 4 over the last two dims, then a flip of the last
    dim when r >= 4 (the JAX package's ``_dihedral_jax``)."""
    img = torch.rot90(img, int(r) % 4, dims=(-2, -1))
    return torch.flip(img, dims=(-1,)) if r >= 4 else img


def crop_pool(pool, idx, oy, ox, r, crop):
    """Crops of a (N, F, H, W) pool at given indices, each under its
    dihedral transform: ``pool[idx, :, oy:oy+crop, ox:ox+crop]`` then
    ``_dihedral(., r)``, all (B,) tensors, gathered in one pass on the
    pool's device. Returns (B, F, crop, crop) float32."""
    dev = pool.device
    i = torch.arange(crop, device=dev)[:, None].expand(crop, crop)
    j = torch.arange(crop, device=dev)[None, :].expand(crop, crop)
    r = r[:, None, None]
    last = crop - 1
    # out[i, j] = rot[i, j'] with j' the flipped column when r >= 4; rot90
    # by k reads its source at (j', c-1-i), (c-1-i, c-1-j'), (c-1-j', i)
    jf = torch.where(r >= 4, last - j, j)
    k = r % 4
    si = torch.where(k == 0, i, torch.where(k == 1, jf, torch.where(
        k == 2, last - i, last - jf)))
    sj = torch.where(k == 0, jf, torch.where(k == 1, last - i, torch.where(
        k == 2, last - jf, i)))
    rows = oy[:, None, None] + si
    cols = ox[:, None, None] + sj
    out = pool[idx[:, None, None], :, rows, cols]  # (B, crop, crop, F)
    return out.permute(0, 3, 1, 2).float()


def sample_pool_crops(pool, gen, batch, crop):
    """``batch`` random square crops with a random dihedral transform each,
    drawn from ``gen`` on the pool's device.

    Args:
      pool: (N, F, H, W) uint8 or float tensor: N images of F aligned frames
        (F=2 clean+interp pairs, F=3 interp triplets), cropped together.

    Returns (batch, F, crop, crop) float32 in the pool's value scale.
    """
    n, _, h, w = pool.shape
    dev = pool.device

    def randint(hi):
        return torch.randint(0, hi, (batch,), generator=gen, device=dev)

    idx, oy, ox = randint(n), randint(h - crop + 1), randint(w - crop + 1)
    return crop_pool(pool, idx, oy, ox, randint(8), crop)


def make_pool_step(base_loss, pool, batch, crop, device, seed=0):
    """Wrap a ``(model, (clean, interp, step_idx))`` loss with crop sampling
    from ``pool``, an (N, 2, H, W) clean+interp array copied to ``device``
    once: the step's only input is the step counter."""
    pool = torch.as_tensor(pool).to(device)
    assert pool.dim() == 4 and pool.shape[1] == 2, tuple(pool.shape)

    def loss_fn(model, step_idx):
        gen = step_generator(seed, step_idx, pool.device, POOL_STREAM)
        crops = sample_pool_crops(pool, gen, batch, crop)
        return base_loss(model, (crops[:, 0], crops[:, 1], step_idx))

    return make_train_step(loss_fn)


class CounterProvider:
    """Provider for the pool steps: ``next()`` yields the step counter (the
    step's only host input)."""

    def __init__(self, start_iter=0):
        self._c = itertools.count(start_iter + 1)

    def next(self):
        return next(self._c)

    def close(self):
        pass


def make_pool_interp_step(pool, batch, crop, device, frame_swap=False,
                          seed=0, criterion=losses.l1_loss):
    """Interp (IFNet) train step with triplet crops sampled on the card.

    pool: (N, 3, H, W) uint8 triplets. Builds the reference 6-channel input
    (the neighbours replicated x3) and the 1-channel middle label on the
    device (sff_scripts_interp/data/data_provider.py:93-154; the reference's
    'random_flipz' is a transpose, which the 8 dihedral transforms cover;
    ``frame_swap`` reverses the neighbour order of a random half, the 'swap'
    aug). ``criterion(pred, target)`` is the loss, L1 by default (the JAX
    step's only one).
    """
    pool = torch.as_tensor(pool).to(device)
    assert pool.dim() == 4 and pool.shape[1] == 3, tuple(pool.shape)

    def loss_fn(model, step_idx):
        gen = step_generator(seed, step_idx, pool.device, INTERP_POOL_STREAM)
        crops = sample_pool_crops(pool, gen, batch, crop) / 255.0
        if frame_swap:
            rev = torch.rand(batch, generator=gen, device=pool.device) < 0.5
            crops = torch.where(rev[:, None, None, None], crops.flip(1), crops)
        x = torch.cat([crops[:, 0:1].expand(-1, 3, -1, -1),
                       crops[:, 2:3].expand(-1, 3, -1, -1)], dim=1)
        return criterion(model(x), crops[:, 1:2]), {}

    return make_train_step(loss_fn)
