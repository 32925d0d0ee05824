"""SFF interpolation trainer (counterpart of ``sstem_tpu/cli/train_interp.py``
on its host-streaming path; the reference's ``main_ms.py``).

Usage: python -m sstem_tpu_torch.cli.train_interp -c ms_l1loss_decay
           [--config-dir ./config] [--max-iters N] [--device cuda|cpu]

Accepts unmodified reference configs (config name resolved against
``--config-dir``, or a path). It trains IFNet (1 frame) with K =
``TRAIN.kernel_size`` on augmented triplet crops, in float32 with TF32 off,
with the L1, L2 or SSIM loss and Adam (AdamW when ``TRAIN.weight_decay`` is
set) under the poly warmup/decay LR. It writes ``loss.txt``, ``valid.txt``,
preview PNGs and ``model-%06d.ckpt`` files in the reference payload, and
resumes from the latest checkpoint when ``TRAIN.resume`` is set. It runs on
the CUDA card unless ``--device cpu`` is given.
"""

import argparse
import os

import numpy as np
import torch

from sstem_tpu_torch.cli import _sff, common
from sstem_tpu_torch.compat.config import load_sff_config
from sstem_tpu_torch.compat.weights import load_reference
from sstem_tpu_torch.config import disable_tf32
from sstem_tpu_torch.data.providers import (
    AugConfig, InterpTrainDataset, InterpValidDataset, Provider,
)
from sstem_tpu_torch.models import IFNet
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


def build(cfg, device="cuda", seed=0):
    """IFNet from ``seed`` on ``device`` with its optimizer, train step and
    eval step. Returns (model, opt, train_step, eval_fn, schedule);
    train_step(state, (inputs, target)) -> (state, metrics)."""
    tr = cfg.TRAIN
    model = IFNet(kernel_size=tr.kernel_size,
                  generator=torch.Generator().manual_seed(seed)).to(device)
    schedule = _sff.make_schedule(tr)
    opt = make_optimizer(model.parameters(), schedule,
                         weight_decay=tr.weight_decay)
    criterion = _sff.make_pixel_criterion(tr.loss)

    def loss_fn(model, batch):
        inputs, target = batch
        return criterion(model(inputs), target), {}

    return model, opt, make_train_step(loss_fn), make_eval_step(model), schedule


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--cfg", type=str, default="ms_l1loss_decay")
    parser.add_argument("-m", "--mode", type=str, default="train")
    parser.add_argument("--config-dir", type=str, default="./config")
    parser.add_argument("--max-iters", type=int, default=None,
                        help="override cfg.TRAIN.total_iters")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="where to train (default: the CUDA card)")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_interp: no CUDA device; pass --device cpu "
                           "to train on the CPU")
    device = torch.device(args.device)
    disable_tf32()

    cfg = load_sff_config(args.cfg, args.config_dir)
    tr = cfg.TRAIN
    exp_name, paths, logger, writer = common.init_project(
        cfg.NAME, tr.cache_path, tr.save_path
    )
    rng = common.seed_everything(tr.random_seed)

    model, opt, train_step, eval_fn, schedule = build(
        cfg, device, seed=int(rng.integers(1 << 30)))
    state = TrainState(model, opt)

    ds = InterpTrainDataset(
        cfg.DATA.folder_name, cfg.DATA.train_txt,
        patch_size=tuple(cfg.DATA.patch_size), aug=aug_from_cfg(cfg.DATA),
    )
    provider = Provider(ds, tr.batch_size, seed=tr.random_seed, device=device)
    valid_ds = (
        InterpValidDataset(cfg.DATA.folder_name, cfg.DATA.valid_txt)
        if tr.if_valid else None
    )

    start_iter = 0
    if tr.resume:
        ck = restore_checkpoint(paths["save_path"], tr.get("model_id"))
        if ck is not None:
            load_reference(model, ck)
            start_iter = int(ck["current_iter"])

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
            preview_fn=preview_fn,
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
