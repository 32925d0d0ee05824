"""End-to-end verify drive on the card (counterpart of
``tools/verify_drive.py``).

    python -m sstem_tpu_torch.tools.verify_drive [--ckpt-root DIR]

Under the ``highest`` matmul precision (float32 parity; the caller's
policy is set back after):

  1. ``SFFPipeline.restore_stack`` on ``synth_stack(5, 251, 179)``
     (sections 1 and 3, an odd size) on the card against the same pipeline
     on the CPU, where the wrappers run their plain versions (the JAX
     drive's ``set_sepconv_impl("xla")`` side): interp, fused and stitch
     within the JAX drive's share of pixels more than 1 level apart;
  2. ``restore_stack_scanned`` against ``restore_stack`` at chunk 2 on the
     card (sections 1-3, an odd tail group), the stitch counted only where
     a warped level flip does not explain it (``stitch_unexplained_frac``);
  3. the SP restore's ``pred1`` with ``packed_conv`` on (bf16) and off
     (float32) on the card, within 2 levels on all but 1e-3 of pixels;
  4. three steps of a FusionNet(ngf 8) train step (train-mode BatchNorm,
     L1, Adam) on the card, the loss finite.

It prints ``VERIFY PASS`` and exits 0, or ``VERIFY FAIL`` and exits 1;
without a card it prints one ``gpu_unavailable`` line and exits 2.

Weights: the three nets of a finished ``quality_run`` under
``--ckpt-root`` (default ``$VERIFY_CKPT_ROOT``, else ``quality_run``'s own
root, ``build/quality_run`` in the checkout, where the JAX drive reads
``/tmp/sstem_quality``: the port reads nothing outside its checkout unless
told to), through ``cli._ckpt.load_model``; without them, seeded random
weights, where the K=51 interp saturates and the thresholds are the JAX
drive's relaxed ones.
"""

import argparse
import copy
import json
import os
import sys

import numpy as np
import torch

from sstem_tpu_torch.tools._timing import card_missing, generator, policy

K = 51
CARD = "cuda"  # what the drive holds against the CPU
SFF_IDS = [1, 3]
SCANNED_IDS = [1, 2, 3]


def mismatch_frac(a, b, levels=1):
    """Share of pixels of two uint8 images more than ``levels`` apart."""
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return float((d > levels).mean())


def stitch_unexplained_frac(got, want):
    """Share of stitch pixels more than 1 level apart that no warped flip
    explains. The stitch is interp where warped < 2 and warped elsewhere
    (``infer/pipeline.py``), so a warped level that moves by up to 2 across
    the threshold swaps interp for warped: those pixels are not counted.
    ``got`` and ``want`` are one section's {'stitch', 'warped'} uint8."""
    d = np.abs(got["stitch"].astype(np.int16) - want["stitch"].astype(np.int16))
    wg = got["warped"].astype(np.int16)
    ww = want["warped"].astype(np.int16)
    flip = ((wg >= 2) != (ww >= 2)) & (np.abs(wg - ww) <= 2)
    return float(((d > 1) & ~flip).mean())


def sff_models(ckpt_root, seed=0):
    """(IFNet, FusionNet, UNetSFF) and whether they are trained: a finished
    quality run's under ``ckpt_root``, else seeded random ones."""
    from sstem_tpu_torch.models import FusionNet, IFNet, UNetSFF
    from sstem_tpu_torch.tools import quality_run

    try:
        with open(os.path.join(ckpt_root, "stage.json")) as f:
            stage = json.load(f)
    except FileNotFoundError:
        stage = {}
    if all(k in stage for k in ("interp_save", "unfold_save", "fusion_save")):
        print(f"using trained checkpoints from {ckpt_root}", flush=True)
        return quality_run.load_models(stage), True
    print(f"no finished quality run under {ckpt_root}; seeded random "
          "weights", flush=True)
    g = torch.Generator().manual_seed(seed)
    return (IFNet(K, generator=g), FusionNet(output_nc=2, generator=g),
            UNetSFF(generator=g)), False


def _pipeline(models, device):
    from sstem_tpu_torch.infer.pipeline import SFFPipeline

    return SFFPipeline(*copy.deepcopy(models), device=device)


def sff_checks(models, trained, stack):
    """Steps 1 and 2; returns the number of failed checks."""
    interp_tol = 1e-3 if trained else 5e-2
    bad = 0
    outs = {d: _pipeline(models, d).restore_stack(stack, SFF_IDS)
            for d in (CARD, "cpu")}
    for sid in SFF_IDS:
        for key in ("interp", "fused", "stitch"):
            a, b = outs[CARD][sid][key], outs["cpu"][sid][key]
            frac = mismatch_frac(a, b)
            print(f"section {sid} {key}: max uint8 delta "
                  f"{int(np.abs(a.astype(np.int16) - b).max())} "
                  f"(frac>1: {frac:.2e})", flush=True)
            bad += frac > (interp_tol if key == "interp" else 1e-3)

    pipe = _pipeline(models, CARD)
    ref = pipe.restore_stack(stack, SCANNED_IDS, chunk=2)
    scn = pipe.restore_stack_scanned(stack, SCANNED_IDS, chunk=2)
    for sid in SCANNED_IDS:
        for key in ("interp", "fused", "warped", "stitch"):
            a, b = scn[sid][key], ref[sid][key]
            d = int(np.abs(a.astype(np.int16) - b).max())
            frac = mismatch_frac(a, b)
            if key == "stitch":
                unexplained = stitch_unexplained_frac(scn[sid], ref[sid])
                print(f"scanned vs loop section {sid} stitch: max delta {d} "
                      f"(frac>1: {frac:.2e}, unexplained: "
                      f"{unexplained:.2e})", flush=True)
                frac = unexplained
            else:
                print(f"scanned vs loop section {sid} {key}: max delta {d} "
                      f"(frac>1: {frac:.2e})", flush=True)
            # the odd size's border band (restore_stack_scanned's docstring)
            tol = interp_tol if key == "interp" else (
                1e-2 if trained else 2e-2)
            bad += frac > tol
    return bad


def sp_check(stack, seed=0):
    """Step 3; returns the number of failed checks."""
    from sstem_tpu_torch import config
    from sstem_tpu_torch.infer.pipeline import SPPipeline
    from sstem_tpu_torch.models import FusionNetSP, IFNet, UNetSP

    g = torch.Generator().manual_seed(seed)
    nets = (IFNet(K, n_frames=2, generator=g), UNetSP(generator=g),
            FusionNetSP(generator=g))
    i1, d2, d3, i4 = (stack[i][None] for i in range(4))
    mask = np.full(i1.shape, 255.0)
    pred = {}
    for packed in (True, False):
        dtype = config.SERVING_DTYPE if packed else config.PARITY_DTYPE
        sp = SPPipeline(*copy.deepcopy(nets), device=CARD, dtype=dtype,
                        packed_conv=packed)
        res = sp.restore(i1, i4, d2, d3, mask, mask)
        pred[packed] = torch.floor(res["pred1"] * 255).to(torch.int16).cpu()
    d = (pred[True] - pred[False]).abs()
    print(f"SP pred1 packed-vs-cudnn: max uint8 delta {int(d.max())} "
          f"(frac>1: {float((d > 1).float().mean()):.2e})", flush=True)
    return int(float((d > 2).float().mean()) > 1e-3)


def train_check(seed=0):
    """Step 4; returns the number of failed checks."""
    from sstem_tpu_torch.losses import l1_loss
    from sstem_tpu_torch.models import FusionNet

    model = FusionNet(output_nc=2, ngf=8,
                      generator=torch.Generator().manual_seed(seed))
    model = model.to(CARD).train()
    opt = torch.optim.Adam(model.parameters(), 1e-4)
    gen = generator(CARD, seed)
    x = torch.rand((2, 6, 64, 64), generator=gen, device=CARD)
    y = torch.rand((2, 2, 64, 64), generator=gen, device=CARD)
    for _ in range(3):
        loss = l1_loss(model(x), y)
        opt.zero_grad()
        loss.backward()
        opt.step()
    loss = float(loss.detach())
    print(f"train step ok, loss={loss:.6f}", flush=True)
    return int(not np.isfinite(loss))


def main(argv=None):
    from sstem_tpu_torch.tools import quality_run

    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-root", default=os.environ.get(
        "VERIFY_CKPT_ROOT", quality_run.DEFAULT_ROOT))
    args = ap.parse_args(argv)
    if card_missing("verify_drive"):
        return 2
    from sstem_tpu_torch.data import synth_stack

    stack = synth_stack(5, 251, 179, seed=0)
    with policy("highest"):
        models, trained = sff_models(args.ckpt_root)
        bad = sff_checks(models, trained, stack)
        bad += sp_check(stack)
        bad += train_check()
    print("VERIFY " + ("FAIL" if bad else "PASS"), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
