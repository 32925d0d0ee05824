"""SP interpolation (VFI) trainer (counterpart of
``sstem_tpu/cli/train_sp_interp.py``; the reference's ``main_interp.py``).

Usage: python -m sstem_tpu_torch.cli.train_sp_interp -opt CFG
           [--max-iters N] [--resume-torch CKPT] [--device cuda|cpu]

Accepts an unmodified reference SP config (flat YAML, missing keys None).
The two-frame IFNet (K = ``kernel_size``) runs on cat(img_1 x3, img_4 x3)
and predicts sections 2 and 3 in one forward (the reference runs the model
twice to slice the two output channels, main_interp.py:133-134: the same
function). L1 on both frames after the ``PAD`` loss crop; Adam under
StepLR(30, 0.5) stepped once an epoch; float32 (TF32 off by default). It writes
``loss.txt``, 3-row preview collages and ``model-%06d.ckpt`` files in the
reference payload with the optimizer's state (``optimizer_weights``), and
resumes from the newest checkpoint of its save directory. ``--resume-torch``
continues a reference-format checkpoint mid-flight: its weights, Adam's
moments and the update count (main_interp.py:193-196). It runs on the CUDA
card unless ``--device cpu`` is given.
"""

import argparse
import contextlib
import os

import torch

from sstem_tpu_torch import losses
from sstem_tpu_torch.cli import common
from sstem_tpu_torch.cli.train_interp import require_device
from sstem_tpu_torch.compat.config import load_sp_config
from sstem_tpu_torch.compat.weights import load_reference
from sstem_tpu_torch.config import apply_matmul_precision
from sstem_tpu_torch.data.providers import Provider, SPDataset
from sstem_tpu_torch.models import IFNet
from sstem_tpu_torch.models.layers import skip_init
from sstem_tpu_torch.ops import negative_pad_2d
from sstem_tpu_torch.train.checkpoint import restore_checkpoint
from sstem_tpu_torch.train.loop import run_training, save_collage, to_uint8
from sstem_tpu_torch.train.schedules import step_lr
from sstem_tpu_torch.train.trainer import (
    TrainState, make_eval_step, make_optimizer, make_train_step,
)


def vfi_inputs(batch):
    """The two-frame IFNet's input (N, 6, H, W): img_1 x3 ++ img_4 x3."""
    return torch.cat([batch["img_1"]] * 3 + [batch["img_4"]] * 3, dim=1)


def build(cfg, steps_per_epoch, device="cuda", seed=0):
    """IFNet(kernel_size, n_frames=2) from ``seed`` on ``device`` with its
    Adam under ``step_lr``, train step and eval step. Returns (model, opt,
    train_step, eval_fn, schedule); train_step(state, batch) -> (state,
    metrics) on a dict batch of (N, 1, H, W) tensors."""
    model = IFNet(kernel_size=int(cfg.kernel_size or 51), n_frames=2,
                  generator=torch.Generator().manual_seed(seed)).to(device)
    schedule = step_lr(float(cfg.base_lr or 1e-4), 30, 0.5,
                       steps_per_epoch=steps_per_epoch)
    opt = make_optimizer(model.parameters(), schedule)
    pad = int(cfg.PAD or 0)  # the loss crop (main_interp.py:137-140)

    def loss_fn(model, batch):
        pred = model(vfi_inputs(batch))
        l1 = losses.l1_loss(negative_pad_2d(pred[:, 0:1], pad),
                            negative_pad_2d(batch["img_2"], pad))
        l2 = losses.l1_loss(negative_pad_2d(pred[:, 1:2], pad),
                            negative_pad_2d(batch["img_3"], pad))
        return l1 + l2, {"loss_vfi1": l1.detach()}

    return model, opt, make_train_step(loss_fn), make_eval_step(model), schedule


def sp_data(cfg, device, use_vfi=False):
    """The SP trainers' dataset and provider from the config. Returns (ds,
    provider, batch_size, steps_per_epoch)."""
    ds = SPDataset(cfg.data_folder, cfg.data_txt,
                   patch_size=cfg.patch_size or 256,
                   if_rotate=bool(cfg.if_rotate),
                   if_bdadjust=bool(cfg.if_bdadjust), use_vfi=use_vfi)
    batch_size = cfg.batch_size or 1
    provider = Provider(ds, batch_size, seed=cfg.random_seed or 0,
                        device=device)
    return ds, provider, batch_size, max(len(ds) // batch_size, 1)


def resume(model, opt, resume_torch, save_path):
    """Load a run to continue into ``model`` (and ``opt``). Returns the
    step to start after.

    With ``resume_torch`` (a reference-format checkpoint holding
    ``optimizer_weights``): its weights, Adam's moments and the update
    count, which is the step returned. Otherwise the newest
    ``model-%06d.ckpt`` under ``save_path``, weights only, as the JAX
    trainers auto-resume; 0 when there is none."""
    if resume_torch:
        payload = torch.load(resume_torch, map_location="cpu", weights_only=True)
        load_reference(model, payload)
        opt.load_state_dict(payload["optimizer_weights"])
        return opt.count
    ck = restore_checkpoint(save_path)
    if ck is None:
        return 0
    load_reference(model, ck)
    return int(ck["current_iter"])


def sp_arg_parser(default_cfg):
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", "--opt", type=str, default=default_cfg)
    parser.add_argument("--max-iters", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="where to train (default: the CUDA card)")
    return parser


def main(argv=None):
    parser = sp_arg_parser("./config/train_interp.yaml")
    parser.add_argument("--resume-torch", type=str, default=None,
                        help="resume mid-flight from a reference torch .ckpt "
                             "(weights + Adam moments, main_interp.py:193-196)")
    args = parser.parse_args(argv)
    apply_matmul_precision()
    device = require_device(args.device, "train_sp_interp")

    cfg = load_sp_config(args.opt)
    exp_name, paths, logger, writer = common.init_project(
        "sp_interp", cfg.cache_path or "./cache", cfg.save_path or "./models")
    rng = common.seed_everything(cfg.random_seed)
    ds, provider, batch_size, steps_per_epoch = sp_data(
        cfg, device, use_vfi=bool(cfg.if_use_vfiImg))
    # a --resume-torch checkpoint overwrites every initial value
    with skip_init() if args.resume_torch else contextlib.nullcontext():
        model, opt, train_step, eval_fn, schedule = build(
            cfg, steps_per_epoch, device, seed=int(rng.integers(1 << 30)))
    state = TrainState(model, opt)
    start_iter = resume(model, opt, args.resume_torch, paths["save_path"])

    def preview_fn(st, batch, iters):
        pred = eval_fn(vfi_inputs(batch)[:1])[0].float().cpu().numpy()
        b = {k: batch[k][0, 0].cpu().numpy()
             for k in ("img_1", "img_2", "img_3", "img_4")}
        save_collage(
            os.path.join(paths["cache_path"], "%06d.png" % iters),
            [
                [to_uint8(b["img_1"]), to_uint8(b["img_4"])],
                [to_uint8(pred[0]), to_uint8(b["img_2"])],
                [to_uint8(pred[1]), to_uint8(b["img_3"])],
            ],
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
