"""SFF interpolation trainer (counterpart of ``sstem_tpu/cli/train_interp.py``;
the reference's ``main_ms.py``).

Usage: python -m sstem_tpu_torch.cli.train_interp -c ms_l1loss_decay
           [--config-dir ./config] [--max-iters N] [--device-datagen]
           [--vgg-weights VGG19_PTH] [--device cuda|cpu]
       torchrun --nproc-per-node N -m sstem_tpu_torch.cli.train_interp
           -c CFG [--dist-backend nccl|gloo] [...]

Accepts unmodified reference configs (config name resolved against
``--config-dir``, or a path). It trains IFNet (1 frame) with K =
``TRAIN.kernel_size`` on augmented triplet crops, in float32 (TF32 off by default),
with the L1, L2, SSIM or perceptual loss (the last on a frozen VGG19 from
``--vgg-weights``, a torchvision state dict; refused without one) and Adam
(AdamW when ``TRAIN.weight_decay`` is set) under the poly warmup/decay LR. It writes ``loss.txt``, ``valid.txt``,
preview PNGs and ``model-%06d.ckpt`` files in the reference payload, and
resumes from the latest checkpoint when ``TRAIN.resume`` is set. It runs on
the CUDA card unless ``--device cpu`` is given. With ``--device-datagen``
the triplets live on the card as one uint8 pool and the crops, with the
dihedral augmentations and the frame swap, are sampled there
(``train.device_datagen.make_pool_interp_step``, with the same loss); the
host streams only the step counter. It falls back to host streaming when the pixel
augmentations (color jitter, noise, elastic) are on or the images differ
in size.

Under torchrun each process is one rank of a data-parallel run
(``parallel.ddp``): rank r trains on ``cuda:{r % cards}`` (NCCL, the
default backend on the card, needs a card a rank; ``--dist-backend gloo``
lets ranks share one), takes its rows of each global batch of
TRAIN.batch_size (which must divide among the ranks), and the net is
wrapped in DDP; rank 0 alone writes the files. The pool stays one-process
only: under a process group ``--device-datagen`` streams from the host.
"""

import argparse
import os

import numpy as np
import torch

from sstem_tpu_torch.cli import _sff, common
from sstem_tpu_torch.compat.config import load_sff_config
from sstem_tpu_torch.compat.weights import load_reference
from sstem_tpu_torch.config import apply_matmul_precision
from sstem_tpu_torch.data.providers import (
    AugConfig, InterpTrainDataset, InterpValidDataset, Provider,
)
from sstem_tpu_torch.models import IFNet
from sstem_tpu_torch.parallel import ddp
from sstem_tpu_torch.train.device_datagen import (
    CounterProvider, make_pool_interp_step,
)
from sstem_tpu_torch.train.checkpoint import restore_checkpoint
from sstem_tpu_torch.train.loop import run_training, save_collage, to_uint8
from sstem_tpu_torch.train.trainer import (
    TrainState, make_eval_step, make_optimizer, make_train_step,
)


def aug_from_cfg(data):
    a = data.AUG
    return AugConfig(
        random_fliplr=a.random_fliplr, random_flipud=a.random_flipud,
        random_flipz=a.random_flipz, random_rotation=a.random_rotation,
        swap=a.swap, color_jitter=a.color_jitter,
        brightness=a.COLOR.brightness, contrast=a.COLOR.contrast,
        saturation=a.COLOR.saturation, gauss_noise=a.gauss_noise,
        gauss_mean=a.GAUSS.gauss_mean, gauss_sigma=a.GAUSS.gauss_sigma,
        elastic_trans=a.elastic_trans, alpha_range=a.ELASTIC.alpha_range,
        sigma=a.ELASTIC.sigma, shave=a.ELASTIC.shave,
    )


def require_device(device, cli):
    """``--device`` as a torch.device; raises when 'cuda' has no card."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{cli}: no CUDA device; pass --device cpu to "
                           "train on the CPU")
    return torch.device(device)


def build(cfg, device="cuda", seed=0, vgg_weights=None, data_parallel=True):
    """IFNet from ``seed`` on ``device`` with its optimizer, train step and
    eval step. The loss is cfg.TRAIN.loss; the perceptual one runs a frozen
    VGG19 from ``vgg_weights`` with TRAIN.vgg_weight, com_weight and
    loss_combine (defaults 1.0, 1.0, L1; train_interp.py:46-52 of the JAX
    package). With ``data_parallel`` under a process group the model is
    wrapped in DDP (``_sff.data_parallel``); the eval step runs the bare
    net. Returns (model, opt, train_step, eval_fn, schedule, criterion);
    train_step(state, (inputs, target)) -> (state, metrics)."""
    tr = cfg.TRAIN
    model = IFNet(kernel_size=tr.kernel_size,
                  generator=torch.Generator().manual_seed(seed)).to(device)
    schedule = _sff.make_schedule(tr)
    opt = make_optimizer(model.parameters(), schedule,
                         weight_decay=tr.weight_decay)
    vgg_apply = (_sff.load_vgg_apply(vgg_weights, device) if vgg_weights
                 else None)
    criterion = _sff.make_pixel_criterion(
        tr.loss, vgg_apply,
        vgg_weight=tr.get("vgg_weight", 1.0),
        com_weight=tr.get("com_weight", 1.0),
        loss_combine=tr.get("loss_combine", "L1"),
    )

    def loss_fn(model, batch):
        inputs, target = batch
        return criterion(model(inputs), target), {}

    eval_fn = make_eval_step(model)
    if data_parallel:
        model = _sff.data_parallel(model, tr.get("batch_size"), device)
    return model, opt, make_train_step(loss_fn), eval_fn, schedule, criterion


def dist_backend_arg(parser):
    parser.add_argument("--dist-backend", type=str, default=None,
                        choices=["nccl", "gloo"],
                        help="under torchrun: the process group's backend "
                             "(default nccl on the card, gloo on the CPU)")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--cfg", type=str, default="ms_l1loss_decay")
    parser.add_argument("-m", "--mode", type=str, default="train")
    parser.add_argument("--config-dir", type=str, default="./config")
    parser.add_argument("--vgg-weights", type=str, default=None,
                        help="torchvision VGG19 state dict (vgg19-dcbb9e9d"
                             ".pth) for TRAIN.loss: perceptual")
    parser.add_argument("--max-iters", type=int, default=None,
                        help="override cfg.TRAIN.total_iters")
    parser.add_argument("--device-datagen", action="store_true",
                        help="sample the triplet crops from a pool on the "
                             "card (the host streams only the step counter)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="where to train (default: the CUDA card)")
    dist_backend_arg(parser)
    args = parser.parse_args(argv)
    apply_matmul_precision()
    device, joined = common.rank_device(
        require_device(args.device, "train_interp"), args.dist_backend)
    try:
        return run(args, device)
    finally:
        if joined:
            ddp.teardown()


def run(args, device):
    """``main`` after the arguments and the device."""
    cfg = load_sff_config(args.cfg, args.config_dir)
    tr = cfg.TRAIN
    exp_name, paths, logger, writer = common.init_project(
        cfg.NAME, tr.cache_path, tr.save_path
    )
    rng = common.seed_everything(tr.random_seed)

    model, opt, train_step, eval_fn, schedule, criterion = build(
        cfg, device, seed=int(rng.integers(1 << 30)),
        vgg_weights=args.vgg_weights)
    state = TrainState(model, opt)

    aug = aug_from_cfg(cfg.DATA)
    ds = InterpTrainDataset(
        cfg.DATA.folder_name, cfg.DATA.train_txt,
        patch_size=tuple(cfg.DATA.patch_size), aug=aug,
    )
    pool = None
    if args.device_datagen:
        # the pool step does crop, dihedral and frame swap; the pixel augs
        # stay on the host streaming path
        if ddp.world_size() == 1 and not (
                aug.color_jitter or aug.gauss_noise or aug.elastic_trans):
            pool = ds.load_pool()
        if pool is None:
            logger.warning("--device-datagen: falling back to host streaming "
                           "(a process group, pixel augs, or a non-uniform "
                           "or oversized pool)")
        else:
            logger.info("device-datagen: pool on the card %s (%.0f MB)",
                        pool.shape, pool.nbytes / 1e6)
            train_step = make_pool_interp_step(
                pool, tr.batch_size, cfg.DATA.patch_size[0], device,
                frame_swap=aug.swap, seed=int(tr.random_seed or 0),
                criterion=criterion)
    valid_ds = (
        InterpValidDataset(cfg.DATA.folder_name, cfg.DATA.valid_txt)
        if tr.if_valid else None
    )

    start_iter = 0
    if tr.resume:
        ck = restore_checkpoint(paths["save_path"], tr.get("model_id"))
        if ck is not None:
            load_reference(ddp.unwrap(model), ck)
            start_iter = int(ck["current_iter"])
    provider = (CounterProvider(start_iter) if pool is not None else
                Provider(ds, tr.batch_size, seed=tr.random_seed, device=device,
                         rank=ddp.rank(), world=ddp.world_size()))

    def valid_fn(st, iters):
        score = _sff.psnr_valid_loop(eval_fn, valid_ds, device,
                                     paths["valid_path"], iters)
        return score, "psnr"

    def preview_fn(st, batch, iters):
        inputs, target = batch
        pred = eval_fn(inputs[:1])[0].float().cpu().numpy()
        inputs = inputs[:1].cpu().numpy()
        target = target[:1].cpu().numpy()
        save_collage(
            os.path.join(paths["cache_path"], "%06d.png" % iters),
            [
                [to_uint8(inputs[0, 0]), to_uint8(inputs[0, 3])],
                [to_uint8(np.squeeze(pred)), to_uint8(np.squeeze(target[0]))],
            ],
        )

    total = args.max_iters or tr.total_iters
    try:
        run_training(
            provider=provider, train_step=train_step, state=state,
            total_iters=total, cache_path=paths["cache_path"],
            save_path=paths["save_path"], valid_path=paths["valid_path"],
            display_freq=tr.display_freq, save_freq=tr.save_freq,
            valid_fn=valid_fn if tr.if_valid else None,
            preview_fn=None if pool is not None else preview_fn,
            writer=writer, logger=logger,
            start_iter=start_iter, schedule=schedule,
        )
    finally:
        provider.close()
        if writer is not None:
            writer.close()
    return paths


if __name__ == "__main__":
    main()
