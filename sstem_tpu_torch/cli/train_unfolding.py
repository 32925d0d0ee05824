"""SFF correction (unfolding) trainer (counterpart of
``sstem_tpu/cli/train_unfolding.py``; the reference's
``main_flowfusionnet.py``): FusionNet on [degraded x3 ++ interp x3] -> the
2-channel unfolding flow, L1 loss on the ground-truth flow, EPE validation
and a warped preview.

Usage: python -m sstem_tpu_torch.cli.train_unfolding -c CFG
           [--config-dir ./config] [--max-iters N] [--device-datagen]
           [--device cuda|cpu]
       torchrun --nproc-per-node N -m sstem_tpu_torch.cli.train_unfolding
           -c CFG [--dist-backend nccl|gloo] [...]

The training pairs are DATA.train_txt's triplet rows (the middle section is
the clean image) with DATA.interp_train_txt's interp images, which
``infer_interp_trainingset`` writes. Each step degrades DATA.patch_size
crops with a random fold and centre-crops them to DATA.det_size: on the
host (``UnfoldingTrainDataset``), or with ``--device-datagen`` on the
training device (``train.device_datagen``: the whole set as a uint8 pool on
the card when its images share a size, the host then streaming only the
step counter). Float32 (TF32 off by default), Adam (AdamW when TRAIN.weight_decay
is set) under the poly warmup/decay LR. It writes ``loss.txt``,
``valid.txt``, preview PNGs and ``model-%06d.ckpt`` files in the reference
payload, and resumes from the latest checkpoint when TRAIN.resume is set.
It runs on the CUDA card unless ``--device cpu`` is given.

Under torchrun it trains data-parallel as ``train_interp`` does, with
FusionNet's BatchNorms cross-rank (``parallel.ddp.CrossRankBatchNorm2d``:
their statistics span the global batch, as the JAX step's do over its
mesh). ``--device-datagen`` then streams raw crops from the host and each
rank degrades its rows of the global batch on its device (the pool is
one-process only, as in JAX).
"""

import argparse
import itertools
import os

import numpy as np
import torch

from sstem_tpu_torch import losses
from sstem_tpu_torch.cli import _sff, common
from sstem_tpu_torch.cli.train_interp import (
    aug_from_cfg, dist_backend_arg, require_device,
)
from sstem_tpu_torch.compat.config import load_sff_config
from sstem_tpu_torch.compat.weights import load_reference
from sstem_tpu_torch.config import apply_matmul_precision
from sstem_tpu_torch.data.providers import (
    Provider, RawCropPairDataset, UnfoldingTrainDataset, UnfoldingValidDataset,
)
from sstem_tpu_torch.kernels import serving_warp
from sstem_tpu_torch.models import FusionNet
from sstem_tpu_torch.parallel import ddp
from sstem_tpu_torch.train import device_datagen
from sstem_tpu_torch.train.checkpoint import restore_checkpoint
from sstem_tpu_torch.train.loop import run_training, save_collage, to_uint8
from sstem_tpu_torch.train.trainer import (
    TrainState, make_eval_step, make_optimizer, make_train_step,
)


def build(cfg, device="cuda", seed=0, data_parallel=True):
    """FusionNet(TRAIN.output_nc, TRAIN.ngf) from ``seed`` on ``device`` with
    its optimizer, train step and eval step. With ``data_parallel`` under a
    process group the model has cross-rank BatchNorms and is wrapped in DDP
    (``_sff.data_parallel``); the eval step runs the bare net. Returns
    (model, opt, train_step, eval_fn, schedule); train_step(state, (inputs,
    flow2)) -> (state, metrics), L1 on the flow."""
    tr = cfg.TRAIN
    model = FusionNet(output_nc=tr.output_nc, ngf=tr.ngf,
                      generator=torch.Generator().manual_seed(seed)).to(device)
    schedule = _sff.make_schedule(tr)
    opt = make_optimizer(model.parameters(), schedule,
                         weight_decay=tr.weight_decay)

    def loss_fn(model, batch):
        inputs, target = batch
        return losses.l1_loss(model(inputs), target), {}

    eval_fn = make_eval_step(model)
    if data_parallel:
        model = _sff.data_parallel(model, tr.get("batch_size"), device)
    return model, opt, make_train_step(loss_fn), eval_fn, schedule


def make_provider(ds, tr, device):
    """The host stream of TRAIN.batch_size batches (under a process group,
    this rank's rows of each global batch)."""
    return Provider(ds, tr.batch_size, seed=tr.random_seed, device=device,
                    rank=ddp.rank(), world=ddp.world_size())


def datagen_step(cfg, ds, device, base_loss, logger):
    """The ``--device-datagen`` step and its provider factory: from a pool
    on the card when ``ds.load_pool()`` gives one (one process only), else
    over (clean, interp) crops streamed from the host. Returns (train_step,
    provider_fn); provider_fn(start_iter) -> provider."""
    tr = cfg.TRAIN
    seed = int(tr.random_seed or 0)
    pool = None
    if ddp.world_size() == 1:
        pool = ds.load_pool()
    else:
        logger.warning("--device-datagen: the crop pool is one-process "
                       "only; streaming raw crops from the host")
    if pool is not None:
        logger.info("device-datagen: pool on the card %s (%.0f MB)",
                    pool.shape, pool.nbytes / 1e6)
        step = device_datagen.make_pool_step(
            base_loss, pool, tr.batch_size, cfg.DATA.patch_size[0], device,
            seed=seed)
        return step, device_datagen.CounterProvider
    raw_step = make_train_step(base_loss)
    counter = {}

    def step(state, batch):
        # the degradation's draws key off the iteration index, so a resumed
        # run continues the synthetic stream
        clean, interp = batch
        return raw_step(state, (clean, interp, next(counter["it"])))

    def provider_fn(start_iter):
        counter["it"] = itertools.count(start_iter + 1)
        return make_provider(ds, tr, device)

    return step, provider_fn


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--cfg", type=str,
                        default="sff_flowfusionnet_L1_lr0001decay")
    parser.add_argument("-m", "--mode", type=str, default="train")
    parser.add_argument("--config-dir", type=str, default="./config")
    parser.add_argument("--max-iters", type=int, default=None)
    parser.add_argument("--device-datagen", action="store_true",
                        help="fold synthesis and labels on the training "
                             "device (the host streams raw crops, or only "
                             "the step counter with a pool on the card)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="where to train (default: the CUDA card)")
    dist_backend_arg(parser)
    args = parser.parse_args(argv)
    apply_matmul_precision()
    device, joined = common.rank_device(
        require_device(args.device, "train_unfolding"), args.dist_backend)
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
    model, opt, train_step, eval_fn, schedule = build(
        cfg, device, seed=int(rng.integers(1 << 30)))
    state = TrainState(model, opt)

    det = cfg.DATA.get("det_size", 256)
    crop = cfg.DATA.patch_size[0]
    aug = aug_from_cfg(cfg.DATA)
    if args.device_datagen:
        ds = RawCropPairDataset(cfg.DATA.folder_name, cfg.DATA.train_txt,
                                cfg.DATA.interp_train_txt, crop_size=crop,
                                aug=aug)
        train_step, provider_fn = datagen_step(
            cfg, ds, device, device_datagen.make_device_datagen_loss(
                det_size=det, seed=int(tr.random_seed or 0)), logger)
    else:
        ds = UnfoldingTrainDataset(
            cfg.DATA.folder_name, cfg.DATA.train_txt,
            cfg.DATA.interp_train_txt, crop_size=crop, det_size=det,
            label="flow", line_width_range=(5, 50),
            gt_line=cfg.DATA.get("gt_line", False), aug=aug)

        def provider_fn(start_iter):
            return make_provider(ds, tr, device)

    valid_ds = None
    if tr.if_valid and cfg.DATA.get("valid_txt"):
        try:
            valid_ds = UnfoldingValidDataset(cfg.DATA.folder_name,
                                             cfg.DATA.valid_txt)
        except FileNotFoundError:
            logger.warning("valid list missing; validation disabled")

    start_iter = 0
    if tr.resume:
        ck = restore_checkpoint(paths["save_path"], tr.get("model_id"))
        if ck is not None:
            load_reference(ddp.unwrap(model), ck)
            start_iter = int(ck["current_iter"])
    provider = provider_fn(start_iter)

    def valid_fn(st, iters):
        if valid_ds is None:
            return 0.0, "epe"
        return _sff.epe_valid_loop(eval_fn, valid_ds, device), "epe"

    @torch.inference_mode()
    def preview_fn(st, batch, iters):
        # the warped preview (main_flowfusionnet.py:295-301)
        inputs, target = batch
        flow = eval_fn(inputs[:1]).float().permute(0, 2, 3, 1).contiguous()
        warped = serving_warp((inputs[:1, 0, :, :, None] * 255.0).contiguous(),
                              flow)[0, :, :, 0] / 255.0
        inputs = inputs[:1].cpu().numpy()
        target = target[:1].cpu().numpy()
        save_collage(
            os.path.join(paths["cache_path"], "%06d.png" % iters),
            [
                [to_uint8(inputs[0, 0]), to_uint8(inputs[0, 3])],
                [to_uint8(warped.cpu().numpy()),
                 to_uint8(np.linalg.norm(target[0], axis=0) / 50.0)],
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
            start_iter=start_iter, schedule=schedule,
        )
    finally:
        provider.close()
        if writer is not None:
            writer.close()
    return paths


if __name__ == "__main__":
    main()
