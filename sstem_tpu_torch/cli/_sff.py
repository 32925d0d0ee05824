"""Shared pieces for the SFF trainers (counterpart of ``sstem_tpu/cli/_sff.py``:
``make_schedule``, ``make_pixel_criterion``, ``psnr_valid_loop`` and
``epe_valid_loop``)."""

import os

import numpy as np
import torch

from sstem_tpu_torch import losses, metrics
from sstem_tpu_torch.train.schedules import poly_warmup_decay_lr


def make_schedule(tr):
    """cfg.TRAIN -> schedule fn (constant when base == end, main_ms.py:179)."""
    if float(tr.base_lr) == float(tr.end_lr):
        lr = float(np.float32(tr.base_lr))
        return lambda step: lr
    return poly_warmup_decay_lr(tr.base_lr, tr.end_lr, tr.warmup_iters,
                                tr.decay_iters, tr.power)


def make_pixel_criterion(loss_name):
    """cfg.TRAIN.loss in {L1, L2, ssim} (main_ms.py:149-171)."""
    if loss_name == "L1":
        return losses.l1_loss
    if loss_name == "L2":
        return losses.l2_loss
    if loss_name == "ssim":
        return losses.ssim_loss
    if loss_name == "perceptual":
        raise NotImplementedError(
            "the perceptual loss needs VGG19 ImageNet weights, which the "
            "port does not have yet; use L1, L2 or ssim")
    raise AttributeError(f"No this loss function: {loss_name}")


def psnr_valid_loop(eval_fn, dataset, device, preview_path=None, iters=None):
    """Average reference-parity PSNR over a map-style dataset
    (main_ms.py:250-279 semantics: clip pred to [0,1], compute_psnr)."""
    total = 0.0
    for k in range(len(dataset)):
        im, gt = dataset[k]
        pred = eval_fn(torch.from_numpy(im[None]).to(device))[0].float().cpu()
        pred = np.clip(np.squeeze(pred.numpy()), 0.0, 1.0)
        gt = np.squeeze(gt)
        out = metrics.compute_psnr(pred, gt)
        psnr = 1e12 if not isinstance(out, tuple) else out[1]
        total += psnr
        if k == 0 and preview_path is not None:
            from sstem_tpu_torch.train.loop import save_collage, to_uint8

            save_collage(
                os.path.join(preview_path, "%06d.png" % iters),
                [[to_uint8(pred), to_uint8(gt)]],
            )
    return total / max(len(dataset), 1)


def epe_valid_loop(eval_fn, dataset, device):
    """Average EPE over a map-style flow dataset (main_flowfusionnet.py:266):
    ``eval_fn`` maps a (1, 6, H, W) input to a (1, 2, H, W) flow; the
    dataset's flows are (2, H, W)."""
    total = 0.0
    for k in range(len(dataset)):
        im, gt_flow = dataset[k]
        pred = eval_fn(torch.from_numpy(im[None]).to(device)).float()
        gt = torch.from_numpy(gt_flow[None]).to(device)
        total += float(losses.epe(pred.permute(0, 2, 3, 1),
                                  gt.permute(0, 2, 3, 1)))
    return total / max(len(dataset), 1)
