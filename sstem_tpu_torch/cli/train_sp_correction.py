"""SP correction (denoise) trainer (counterpart of
``sstem_tpu/cli/train_sp_correction.py``; the reference's
``main_correction.py``).

Usage: python -m sstem_tpu_torch.cli.train_sp_correction -opt CFG
           [--max-iters N] [--resume-torch CKPT] [--device cuda|cpu]

The denoising U-Net (UNetSP, 1 -> 1) runs in train mode on degraded
section 2, then on degraded section 3, so its BatchNorm running statistics
are updated twice a step, the second update from the first's (as the JAX
trainer threads ``batch_stats`` through both applications); L1 against the
clean sections after the ``PAD`` loss crop. Adam under StepLR(30, 0.5)
stepped once an epoch, float32 (TF32 off by default). Files, checkpoints (with the
optimizer's state), auto-resume, ``--resume-torch`` and ``--device`` as in
``train_sp_interp``.
"""

import contextlib
import os

import torch

from sstem_tpu_torch import losses
from sstem_tpu_torch.cli import common
from sstem_tpu_torch.cli.train_interp import require_device
from sstem_tpu_torch.cli.train_sp_interp import resume, sp_arg_parser, sp_data
from sstem_tpu_torch.compat.config import load_sp_config
from sstem_tpu_torch.config import apply_matmul_precision
from sstem_tpu_torch.models import UNetSP
from sstem_tpu_torch.models.layers import skip_init
from sstem_tpu_torch.ops import negative_pad_2d
from sstem_tpu_torch.train.loop import run_training, save_collage, to_uint8
from sstem_tpu_torch.train.schedules import step_lr
from sstem_tpu_torch.train.trainer import (
    TrainState, make_eval_step, make_optimizer, make_train_step,
)


def build(cfg, steps_per_epoch, device="cuda", seed=0):
    """UNetSP(1) from ``seed`` on ``device`` with its Adam under
    ``step_lr``, train step and eval step. Returns (model, opt, train_step,
    eval_fn, schedule)."""
    model = UNetSP(n_classes=1,
                   generator=torch.Generator().manual_seed(seed)).to(device)
    schedule = step_lr(float(cfg.base_lr or 1e-4), 30, 0.5,
                       steps_per_epoch=steps_per_epoch)
    opt = make_optimizer(model.parameters(), schedule)
    pad = int(cfg.PAD or 0)  # the loss crop (main_correction.py:144-149)

    def loss_fn(model, batch):
        p1 = model(batch["img_2_degra"])
        p2 = model(batch["img_3_degra"])
        loss = losses.l1_loss(
            negative_pad_2d(p1, pad), negative_pad_2d(batch["img_2"], pad)
        ) + losses.l1_loss(
            negative_pad_2d(p2, pad), negative_pad_2d(batch["img_3"], pad))
        return loss, {}

    return model, opt, make_train_step(loss_fn), make_eval_step(model), schedule


def main(argv=None):
    parser = sp_arg_parser("./config/train_correc.yaml")
    parser.add_argument("--resume-torch", type=str, default=None,
                        help="resume mid-flight from a reference torch .ckpt "
                             "(weights + Adam moments)")
    args = parser.parse_args(argv)
    apply_matmul_precision()
    device = require_device(args.device, "train_sp_correction")

    cfg = load_sp_config(args.opt)
    exp_name, paths, logger, writer = common.init_project(
        "sp_correction", cfg.cache_path or "./cache",
        cfg.save_path or "./models")
    rng = common.seed_everything(cfg.random_seed)
    ds, provider, batch_size, steps_per_epoch = sp_data(cfg, device)
    # a --resume-torch checkpoint overwrites every initial value
    with skip_init() if args.resume_torch else contextlib.nullcontext():
        model, opt, train_step, eval_fn, schedule = build(
            cfg, steps_per_epoch, device, seed=int(rng.integers(1 << 30)))
    state = TrainState(model, opt)
    start_iter = resume(model, opt, args.resume_torch, paths["save_path"])

    def preview_fn(st, batch, iters):
        pred = eval_fn(batch["img_2_degra"][:1])[0, 0].float().cpu().numpy()
        save_collage(
            os.path.join(paths["cache_path"], "%06d.png" % iters),
            [[to_uint8(batch["img_2_degra"][0, 0].cpu().numpy()),
              to_uint8(pred), to_uint8(batch["img_2"][0, 0].cpu().numpy())]],
        )

    total = args.max_iters or (int(cfg.n_epochs or 300) * steps_per_epoch)
    try:
        run_training(
            provider=provider, train_step=train_step, state=state,
            total_iters=total, cache_path=paths["cache_path"],
            save_path=paths["save_path"],
            display_freq=int(cfg.valid_freq or 100),
            save_freq=int(cfg.save_freq or 1000),
            preview_fn=preview_fn, writer=writer, logger=logger,
            start_iter=start_iter, schedule=schedule, save_optimizer=True,
        )
    finally:
        provider.close()
        if writer is not None:
            writer.close()
    return paths


if __name__ == "__main__":
    main()
