"""Shared pieces for the SFF trainers (counterpart of ``sstem_tpu/cli/_sff.py``:
``make_schedule``, ``make_pixel_criterion``, ``load_vgg_apply``,
``psnr_valid_loop`` and ``epe_valid_loop``; and ``data_parallel``, the
port's form of the JAX trainers' data-parallel ``build``)."""

import functools
import os

import numpy as np
import torch

from sstem_tpu_torch import losses, metrics
from sstem_tpu_torch.parallel import ddp
from sstem_tpu_torch.train.schedules import poly_warmup_decay_lr


def data_parallel(model, batch_size, device):
    """The trained net as the train step takes it. Under a process group:
    every BatchNorm made cross-rank (``ddp.convert_batchnorm``) and the net
    wrapped in DDP (``ddp.wrap``), after checking that ``batch_size``, the
    global batch, divides among the ranks (a ValueError naming both
    numbers; the JAX trainers fall back to one device instead, which under
    torchrun would repeat the work on every rank). Without a group:
    ``model`` itself."""
    if not ddp.is_distributed():
        return model
    ddp.local_batch_size(batch_size, ddp.world_size())
    return ddp.wrap(ddp.convert_batchnorm(model), device)


def make_schedule(tr):
    """cfg.TRAIN -> schedule fn (constant when base == end, main_ms.py:179)."""
    if float(tr.base_lr) == float(tr.end_lr):
        lr = float(np.float32(tr.base_lr))
        return lambda step: lr
    return poly_warmup_decay_lr(tr.base_lr, tr.end_lr, tr.warmup_iters,
                                tr.decay_iters, tr.power)


def make_pixel_criterion(loss_name, vgg_apply=None, vgg_weight=1.0,
                         com_weight=1.0, loss_combine="L1"):
    """cfg.TRAIN.loss in {L1, L2, ssim, perceptual} (main_ms.py:149-171);
    the perceptual loss needs ``vgg_apply`` (``load_vgg_apply``)."""
    if loss_name == "L1":
        return losses.l1_loss
    if loss_name == "L2":
        return losses.l2_loss
    if loss_name == "ssim":
        return losses.ssim_loss
    if loss_name == "perceptual":
        if vgg_apply is None:
            raise AssertionError(
                "perceptual loss needs VGG19 weights — pass --vgg-weights "
                "(torch vgg19-dcbb9e9d.pth)")
        return functools.partial(
            losses.perceptual_loss, vgg_apply, vgg_weight=vgg_weight,
            com_weight=com_weight, combine=loss_combine,
        )
    raise AttributeError(f"No this loss function: {loss_name}")


def load_vgg_apply(weights_path, device):
    """A frozen VGG19Features on ``device`` from a torchvision VGG19 state
    dict file, called as x -> the relu{1..5}_1 taps: eval mode, no
    parameter takes a gradient, and, being no submodule of the trained net,
    it is in no optimizer or checkpoint."""
    from sstem_tpu_torch.models.layers import skip_init
    from sstem_tpu_torch.models.vgg import (
        VGG19Features, load_torch_vgg19_features,
    )

    with skip_init():
        model = VGG19Features()
    model.load_state_dict(load_torch_vgg19_features(weights_path), strict=True)
    model = model.to(device).eval().requires_grad_(False)
    return model


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
