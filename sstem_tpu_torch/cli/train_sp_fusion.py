"""SP joint fusion trainer (counterpart of ``sstem_tpu/cli/train_sp_fusion.py``;
the reference's SP ``main_fusion.py``).

Usage: python -m sstem_tpu_torch.cli.train_sp_fusion -opt CFG
           [--max-iters N] [--device cuda|cpu]

Three nets trained jointly, each branch with its own Adam learning rate,
``base_lr`` times its weight (the reference's configs: vfi 1e-20, denoise
1e-6, so both are in effect frozen), each under StepLR(30, 0.5):

  vfi (two-frame IFNet) -> vfi1, vfi2
  denoise (UNetSP)      -> den1, den2 (train-mode BN, statistics chained)
  mask blend: fusion's inputs are vfi * (1 - m) and den * m, with m the
      grad masks (mode 'a') or the generated masks (mode 'b')
  fusion (FusionNetSP, adds its inputs) -> pred1, pred2 (chained likewise)
  loss = the 6 L1 terms (vfi, denoise, fusion on both sections), or the
      fusion terms alone (``if_fusion_loss_only``)

The three branches are the children ``vfi``, ``denoise`` and ``fusion`` of
one module, so a step's checkpoint holds all three (``vfi.conv32.0.weight``,
...); steps are saved without the optimizer, and at the end one
reference-format checkpoint per branch goes under
``save_path/{vfi,denoise,fusion}/``. With ``if_pretrained`` and
``resume_path`` set, the vfi and denoise branches start from
``model-%06d.ckpt`` at ``vfi_last_iter`` and ``denoise_last_iter``: under
``resume_path/vfi`` and ``resume_path/denoise`` where those exist (the
layout this trainer writes at its end), else under ``resume_path`` itself
(the JAX trainer's). Float32 (TF32 off by default); on the CUDA card unless
``--device cpu`` is given.
"""

import contextlib
import os

import torch
from torch import nn

from sstem_tpu_torch import losses
from sstem_tpu_torch.cli import common
from sstem_tpu_torch.cli.train_interp import require_device
from sstem_tpu_torch.cli.train_sp_interp import sp_arg_parser, sp_data, vfi_inputs
from sstem_tpu_torch.compat.config import load_sp_config
from sstem_tpu_torch.compat.weights import load_reference
from sstem_tpu_torch.config import apply_matmul_precision
from sstem_tpu_torch.models import FusionNetSP, IFNet, UNetSP
from sstem_tpu_torch.models.layers import skip_init
from sstem_tpu_torch.ops import negative_pad_2d
from sstem_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from sstem_tpu_torch.train.loop import run_training, save_collage, to_uint8
from sstem_tpu_torch.train.schedules import step_lr
from sstem_tpu_torch.train.trainer import TrainState, make_optimizer, make_train_step

BRANCHES = ("vfi", "denoise", "fusion")


class SPFusionModel(nn.Module):
    """The three branches as one module: ``vfi`` (IFNet, two frames),
    ``denoise`` (UNetSP) and ``fusion`` (FusionNetSP). The branches named in
    ``loaded`` draw no initial values (they are loaded next)."""

    def __init__(self, kernel_size=51, generator=None, loaded=()):
        super().__init__()
        nets = {"vfi": lambda: IFNet(kernel_size, n_frames=2,
                                     generator=generator),
                "denoise": lambda: UNetSP(1, generator=generator),
                "fusion": lambda: FusionNetSP(1, generator=generator)}
        for name in BRANCHES:
            with skip_init() if name in loaded else contextlib.nullcontext():
                setattr(self, name, nets[name]())


def sp_masks(batch, mode):
    """(m2, m3, 1 - m2, 1 - m3): the grad masks (mode 'a') or the generated
    masks (mode 'b') of sections 2 and 3 and their reversals."""
    if mode == "a":
        m2 = batch["img_2_degraB1_mask_gradall"]
        m3 = batch["img_3_degraB1_mask_gradall"]
    else:
        m2 = batch["img_2_degraB1_GenGradMask"]
        m3 = batch["img_3_degraB1_GenGradMask"]
    return m2, m3, 1.0 - m2, 1.0 - m3


def sp_fusion_forward(model, batch, mode):
    """Returns (pred1, pred2, (vfi1, vfi2), (den1, den2)). BatchNorm runs as
    the branches' modes say: in train mode each U-Net's running statistics
    are updated by its section-2 application, then by its section-3 one."""
    m2, m3, m2r, m3r = sp_masks(batch, mode)
    vfi = model.vfi(vfi_inputs(batch))
    vfi1, vfi2 = vfi[:, 0:1], vfi[:, 1:2]
    den1 = model.denoise(batch["img_2_degra"])
    den2 = model.denoise(batch["img_3_degra"])
    p1 = model.fusion(vfi1 * m2r, den1 * m2)
    p2 = model.fusion(vfi2 * m3r, den2 * m3)
    return p1, p2, (vfi1, vfi2), (den1, den2)


def build(cfg, steps_per_epoch, device="cuda", seed=0, loaded=()):
    """The three branches from ``seed`` on ``device`` (those in ``loaded``
    without initial values), one Adam param group a branch with its own
    ``step_lr(base_lr * weight)``, the train step and the eval step.
    Returns (model, opt, train_step, eval_fn, mode); eval_fn(batch) ->
    (pred1, pred2)."""
    model = SPFusionModel(int(cfg.kernel_size or 51),
                          torch.Generator().manual_seed(seed), loaded).to(device)
    base_lr = float(cfg.base_lr or 1e-4)
    lr_weights = {"vfi": float(cfg.vfi_lr_weight or 1.0),
                  "denoise": float(cfg.denoise_lr_weight or 1.0),
                  "fusion": 1.0}
    opt = make_optimizer(
        [{"params": getattr(model, b).parameters(),
          "schedule": step_lr(base_lr * lr_weights[b], 30, 0.5,
                              steps_per_epoch=steps_per_epoch)}
         for b in BRANCHES], None)
    mode = cfg.mode or "b"
    fusion_only = bool(cfg.if_fusion_loss_only)
    pad = int(cfg.PAD or 0)  # the loss crop (main_fusion.py:228-233)

    def crop(x):
        return negative_pad_2d(x, pad)

    def loss_fn(model, batch):
        p1, p2, (v1, v2), (d1, d2) = sp_fusion_forward(model, batch, mode)
        t1, t2 = crop(batch["img_2"]), crop(batch["img_3"])
        lf = losses.l1_loss(crop(p1), t1) + losses.l1_loss(crop(p2), t2)
        if fusion_only:
            loss = lf
        else:
            lv = losses.l1_loss(crop(v1), t1) + losses.l1_loss(crop(v2), t2)
            ld = losses.l1_loss(crop(d1), t1) + losses.l1_loss(crop(d2), t2)
            loss = lv + ld + lf
        return loss, {"loss_fusion": lf.detach()}

    @torch.inference_mode()
    def eval_fn(batch):
        model.eval()
        p1, p2, _, _ = sp_fusion_forward(model, batch, mode)
        return p1, p2

    return model, opt, make_train_step(loss_fn), eval_fn, mode


def _load_branch(path, step, branch):
    """The reference-format payload of ``model-%06d.ckpt`` at ``step`` under
    ``path/branch`` where that directory exists, else under ``path``."""
    sub = os.path.join(path, branch)
    return restore_checkpoint(sub if os.path.isdir(sub) else path, step)


def pretrained_branches(cfg):
    """{branch: checkpoint payload} of the vfi and denoise branches that
    start pretrained (``if_pretrained``, ``resume_path``,
    ``if_pretrained_{vfi,denoise}`` and ``{vfi,denoise}_last_iter``)."""
    if not (cfg.if_pretrained and cfg.resume_path):
        return {}
    out = {}
    for branch in ("vfi", "denoise"):
        step = cfg.get(f"{branch}_last_iter")
        if cfg.get(f"if_pretrained_{branch}") and step:
            out[branch] = _load_branch(cfg.resume_path, int(step), branch)
    return out


def main(argv=None):
    parser = sp_arg_parser("./config/train_fusion.yaml")
    args = parser.parse_args(argv)
    apply_matmul_precision()
    device = require_device(args.device, "train_sp_fusion")

    cfg = load_sp_config(args.opt)
    exp_name, paths, logger, writer = common.init_project(
        "sp_fusion", cfg.cache_path or "./cache", cfg.save_path or "./models")
    rng = common.seed_everything(cfg.random_seed)
    ds, provider, batch_size, steps_per_epoch = sp_data(cfg, device)
    pretrained = pretrained_branches(cfg)
    model, opt, train_step, eval_fn, mode = build(
        cfg, steps_per_epoch, device, seed=int(rng.integers(1 << 30)),
        loaded=tuple(pretrained))
    for branch, payload in pretrained.items():
        # the denoise branch with its BN running statistics
        load_reference(getattr(model, branch), payload)
        logger.info("%s branch loaded from %s", branch, cfg.resume_path)
    state = TrainState(model, opt)

    def preview_fn(st, batch, iters):
        p1, _ = eval_fn(batch)
        save_collage(
            os.path.join(paths["cache_path"], "%06d.png" % iters),
            [[to_uint8(batch["img_2_degra"][0, 0].cpu().numpy()),
              to_uint8(p1[0, 0].cpu().numpy()),
              to_uint8(batch["img_2"][0, 0].cpu().numpy())]],
        )

    total = args.max_iters or (int(cfg.n_epochs or 300) * steps_per_epoch)
    try:
        state = run_training(
            provider=provider, train_step=train_step, state=state,
            total_iters=total, cache_path=paths["cache_path"],
            save_path=paths["save_path"],
            display_freq=int(cfg.valid_freq or 100),
            save_freq=int(cfg.save_freq or 1000),
            preview_fn=preview_fn, writer=writer, logger=logger,
        )
        # per-branch checkpoints (the reference's model_{vfi,denoise,fusion})
        for branch in BRANCHES:
            branch_dir = os.path.join(paths["save_path"], branch)
            os.makedirs(branch_dir, exist_ok=True)
            save_checkpoint(branch_dir, state.opt.count,
                            getattr(state.model, branch).state_dict())
    finally:
        provider.close()
        if writer is not None:
            writer.close()
    return paths


if __name__ == "__main__":
    main()
