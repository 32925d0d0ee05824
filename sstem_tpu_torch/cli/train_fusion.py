"""SFF fusion trainer (counterpart of ``sstem_tpu/cli/train_fusion.py``; the
reference's SFF ``main_fusion.py``): a frozen flow FusionNet (loaded from
TRAIN.flownet_path/TRAIN.flownet_id) predicts the unfolding flow, the
degraded section is backward-warped with the zero-border warp
(``kernels.serving_warp``), and the fusion U-Net (UNetSFF) is trained with
L1 against the clean section (main_fusion.py:213-260); validation scores
PSNR through the whole chain.

Usage: python -m sstem_tpu_torch.cli.train_fusion -c CFG
           [--config-dir ./config] [--max-iters N] [--device-datagen]
           [--resume-from SAVE_DIR] [--device cuda|cpu]
       torchrun --nproc-per-node N -m sstem_tpu_torch.cli.train_fusion
           -c CFG [--dist-backend nccl|gloo] [...]

The flow checkpoint is a reference-format torch file, or a port trainer's
save directory (its newest ``model-NNNNNN.ckpt``). Data, ``--device-datagen``
(line width 5..20), the files written and TRAIN.resume are as in
``train_unfolding``; checkpoints also hold the optimizer's state
(``optimizer_weights``), and ``--resume-from`` continues a previous run from
its save directory's newest checkpoint (weights, Adam's moments and the
schedule's count), writing to this run's own directory. It runs on the CUDA
card unless ``--device cpu`` is given.

Under torchrun it trains data-parallel as ``train_unfolding`` does, with
UNetSFF's BatchNorms cross-rank and UNetSFF alone in DDP: the frozen flow
net stays outside it, in eval mode, on every rank.
"""

import argparse
import os

import numpy as np
import torch

from sstem_tpu_torch import losses
from sstem_tpu_torch.cli import _sff, common
from sstem_tpu_torch.cli._ckpt import load_model
from sstem_tpu_torch.cli.train_interp import (
    aug_from_cfg, dist_backend_arg, require_device,
)
from sstem_tpu_torch.cli.train_unfolding import datagen_step, make_provider
from sstem_tpu_torch.compat.config import load_sff_config
from sstem_tpu_torch.compat.weights import load_reference
from sstem_tpu_torch.config import apply_matmul_precision
from sstem_tpu_torch.data.providers import (
    FusionTrainDataset, FusionValidDataset, RawCropPairDataset,
)
from sstem_tpu_torch.kernels import serving_warp
from sstem_tpu_torch.models import FusionNet, UNetSFF
from sstem_tpu_torch.parallel import ddp
from sstem_tpu_torch.train.checkpoint import restore_checkpoint
from sstem_tpu_torch.train.device_datagen import degraded_batch
from sstem_tpu_torch.train.loop import run_training, save_collage, to_uint8
from sstem_tpu_torch.train.trainer import (
    TrainState, make_optimizer, make_train_step,
)


def compose_forward(flow_model, unet, inputs):
    """Frozen flow -> warp of the degraded section -> fusion U-Net.

    ``inputs`` is (N, 6, H, W) [degraded x3 ++ interp x3]. The flow net runs
    as the caller left it, which is eval mode (``load_flow_model``): the
    reference freezes it with ``model_flow.eval()``
    (sff_scripts_fusion/main_fusion.py:189), so its BatchNorms use their
    running statistics in training as at inference. It is not a child of
    ``unet``, so the train step's ``unet.train()`` does not reach it. The
    flow and the warp run without autograd: the flow is frozen and the
    warped image is data. The three degraded channels are equal, so channel
    0 is warped once and repeated.
    """
    with torch.no_grad():
        flow = flow_model(inputs).to(inputs.dtype).permute(0, 2, 3, 1)
        warped = serving_warp(inputs[:, 0, :, :, None].contiguous(),
                              flow.contiguous())
    warped = warped.permute(0, 3, 1, 2).expand(-1, 3, -1, -1)
    return unet(torch.cat([warped, inputs[:, 3:6]], dim=1))


def load_flow_model(path, ngf, device):
    """The frozen flow FusionNet(ngf) from a reference-format checkpoint
    file or a port trainer's save directory, on ``device``, in eval mode,
    with ``requires_grad`` off."""
    model = load_model(lambda: FusionNet(ngf=ngf), path)
    return model.to(device).eval().requires_grad_(False)


def build(cfg, flow_model, device="cuda", seed=0, data_parallel=True):
    """UNetSFF(TRAIN.output_nc) from ``seed`` on ``device`` behind the frozen
    ``flow_model``, with its optimizer, train step and eval step. With
    ``data_parallel`` under a process group the U-Net has cross-rank
    BatchNorms and is wrapped in DDP (``_sff.data_parallel``); the flow net
    stays outside, and the eval step runs the bare U-Net. Returns (unet,
    opt, train_step, eval_fn, schedule); train_step(state, (inputs, clean))
    -> (state, metrics), L1 on the fused section."""
    tr = cfg.TRAIN
    unet = UNetSFF(out_channel=tr.output_nc,
                   generator=torch.Generator().manual_seed(seed)).to(device)
    schedule = _sff.make_schedule(tr)
    opt = make_optimizer(unet.parameters(), schedule,
                         weight_decay=tr.weight_decay)

    def loss_fn(model, batch):
        inputs, target = batch
        return losses.l1_loss(compose_forward(flow_model, model, inputs),
                              target), {}

    @torch.inference_mode()
    def eval_fn(x):
        bare.eval()
        return compose_forward(flow_model, bare, x)

    bare = unet
    if data_parallel:
        unet = _sff.data_parallel(unet, tr.get("batch_size"), device)
    return unet, opt, make_train_step(loss_fn), eval_fn, schedule


def make_fusion_devgen_loss(flow_model, det_size=256, seed=0):
    """The fusion loss on (clean, interp, step_idx) uint8 crop batches: the
    fold synthesis on the device (line width 5..20, as the fusion dataset
    draws it; sff_scripts_fusion/data/data_provider.py:163-185), then the
    frozen-flow warp and the U-Net, L1 against the clean centre crop."""

    def loss_fn(model, batch):
        clean, interp, step_idx = batch
        inputs, _, target = degraded_batch(
            clean, interp, step_idx, seed, det_size,
            line_width_range=(5, 20))
        return losses.l1_loss(compose_forward(flow_model, model, inputs),
                              target), {}

    return loss_fn


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--cfg", type=str,
                        default="sff_fusion_L1_lr0001decay")
    parser.add_argument("-m", "--mode", type=str, default="train")
    parser.add_argument("--config-dir", type=str, default="./config")
    parser.add_argument("--max-iters", type=int, default=None)
    parser.add_argument("--device-datagen", action="store_true",
                        help="fold synthesis, the frozen-flow warp and the "
                             "labels on the training device")
    parser.add_argument("--resume-from", type=str, default=None,
                        help="save dir of a previous run to continue from "
                             "(its newest model-*.ckpt; new checkpoints go "
                             "to this run's own directory)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="where to train (default: the CUDA card)")
    dist_backend_arg(parser)
    args = parser.parse_args(argv)
    apply_matmul_precision()
    device, joined = common.rank_device(
        require_device(args.device, "train_fusion"), args.dist_backend)
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
    flow_model = load_flow_model(
        os.path.join(tr.flownet_path, tr.flownet_id), tr.ngf, device)
    unet, opt, train_step, eval_fn, schedule = build(
        cfg, flow_model, device, seed=int(rng.integers(1 << 30)))
    state = TrainState(unet, opt)

    det = cfg.DATA.get("det_size", 256)
    crop = cfg.DATA.patch_size[0]
    aug = aug_from_cfg(cfg.DATA)
    if args.device_datagen:
        ds = RawCropPairDataset(cfg.DATA.folder_name, cfg.DATA.train_txt,
                                cfg.DATA.interp_train_txt, crop_size=crop,
                                aug=aug)
        train_step, provider_fn = datagen_step(
            cfg, ds, device, make_fusion_devgen_loss(
                flow_model, det, seed=int(tr.random_seed or 0)), logger)
    else:
        ds = FusionTrainDataset(
            cfg.DATA.folder_name, cfg.DATA.train_txt,
            cfg.DATA.interp_train_txt, crop_size=crop, det_size=det,
            gt_line=cfg.DATA.get("gt_line", False), aug=aug)

        def provider_fn(start_iter):
            return make_provider(ds, tr, device)

    valid_ds = None
    if tr.if_valid and cfg.DATA.get("valid_txt"):
        try:
            valid_ds = FusionValidDataset(cfg.DATA.folder_name,
                                          cfg.DATA.valid_txt)
        except FileNotFoundError:
            logger.warning("valid list missing; validation disabled")

    start_iter = 0
    resume_dir = args.resume_from or (paths["save_path"] if tr.resume
                                      else None)
    if resume_dir:
        ck = restore_checkpoint(resume_dir, None if args.resume_from
                                else tr.get("model_id"))
        if ck is not None:
            load_reference(ddp.unwrap(unet), ck)
            start_iter = int(ck["current_iter"])
            if "optimizer_weights" in ck:
                opt.load_state_dict(ck["optimizer_weights"])
            else:
                logger.info("resumed at iter %d without optimizer state "
                            "(Adam moments restart)", start_iter)
    provider = provider_fn(start_iter)

    def valid_fn(st, iters):
        if valid_ds is None:
            return 0.0, "psnr"
        return _sff.psnr_valid_loop(eval_fn, valid_ds, device,
                                    paths["valid_path"], iters), "psnr"

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
            display_freq=tr.display_freq, valid_freq=tr.valid_freq,
            save_freq=tr.save_freq, valid_fn=valid_fn,
            preview_fn=None if args.device_datagen else preview_fn,
            writer=writer, logger=logger,
            start_iter=start_iter, save_optimizer=True, schedule=schedule,
        )
    finally:
        provider.close()
        if writer is not None:
            writer.close()
    return paths


if __name__ == "__main__":
    main()
