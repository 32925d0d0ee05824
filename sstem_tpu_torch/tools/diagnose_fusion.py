"""Where the fused stage gains or loses PSNR against the interp (counterpart
of ``tools/diagnose_fusion.py``), on the evaluation stack of a finished
``quality_run`` (its ``<root>/stage.json``):

* region-split PSNR — inside the fold strip (tissue destroyed; the interp is
  the only source) against off the strip (the unfolding warp recovers the
  real displaced tissue, where the fused output should win);
* flow quality — the EPE of the predicted unfolding flow against the GT
  ``flow2`` that the degradation synthesized, for the eval-mode flow net
  and for its batch-statistics forward;
* ablations — the same fusion U-Net fed (a) a GT-flow warp (what the flow
  net's error costs) and (b) the batch-statistics flow;
* checkpoint curves — the fused PSNR at every fusion checkpoint, and the
  EPE and off-strip warped PSNR at every unfolding checkpoint.

    python -m sstem_tpu_torch.tools.diagnose_fusion [--root DIR]
        [--stack-size 768] [--out DIAG.json] [--no-curve]
        [--device cuda|cpu]

The nets run in float32 at the precision policy in force (``"highest"`` in
a fresh process); the warps are ``ops.warp.spatial_transform``.
"""

import argparse
import copy
import glob
import json
import os

import numpy as np


def psnr01(gt, pred, region=None):
    """PSNR on 0..255 uint8-scale arrays, reference normalization (/255,
    PIXEL_MAX=1 — psnr_ssim.py:7-20), optionally masked to a region."""
    d = (np.asarray(gt, np.float64) - np.asarray(pred, np.float64)) / 255.0
    if region is not None:
        region = np.asarray(region, bool)
        if not region.any():
            return float("nan")
        d = d[region]
    mse = float(np.mean(d * d))
    if mse < 1e-10:
        return 1e12
    return float(10.0 * np.log10(1.0 / mse))


def parser():
    from sstem_tpu_torch.tools.quality_run import DEFAULT_ROOT

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=DEFAULT_ROOT)
    ap.add_argument("--stack-size", type=int, default=768)
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-curve", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def _step(ckpt):
    return int(os.path.basename(ckpt).split("-")[1].split(".")[0])


def main(argv=None):
    """Prints the report as JSON (and writes it to ``--out``); returns it."""
    import torch

    from sstem_tpu_torch.cli._ckpt import load_model
    from sstem_tpu_torch.infer.pipeline import SFFPipeline
    from sstem_tpu_torch.models import FusionNet, UNetSFF
    from sstem_tpu_torch.ops.warp import spatial_transform
    from sstem_tpu_torch.tools.quality_run import eval_stack, load_models

    args = parser().parse_args(argv)
    with open(os.path.join(args.root, "stage.json")) as f:
        stage = json.load(f)

    # the eval data: quality_run's evaluation stack
    clean, degraded, ids, gt = eval_stack(args.stack_size)
    pipe = SFFPipeline(*load_models(stage), device=args.device)
    dev = pipe.device
    flow_ev_model, unet = pipe.flow_model, pipe.fusion_model
    # the batch-statistics forward, on a copy whose running statistics are
    # thrown away (as the JAX tool drops flax's mutated batch_stats)
    flow_bs_model = copy.deepcopy(flow_ev_model).train()

    def gray6(a, b):  # (N, H, W) each -> (N, 6, H, W)
        return torch.cat([a[:, None].expand(-1, 3, -1, -1),
                          b[:, None].expand(-1, 3, -1, -1)], 1)

    def nhwc(t):
        return t.permute(0, 2, 3, 1)

    @torch.no_grad()
    def flows(model, x):
        return nhwc(model(x)).float()

    @torch.no_grad()
    def fuse(model, warped1, interp1):  # (N, H, W, 1) each
        fused_in = torch.cat([warped1.expand(-1, -1, -1, 3),
                              interp1.expand(-1, -1, -1, 3)], -1)
        return nhwc(model(fused_in.permute(0, 3, 1, 2)).float())

    def to255(t):
        return t[..., 0].clamp(0, 1).cpu().numpy().astype(np.float64) * 255.0

    # per-section stage tensors
    prev = np.stack([degraded[i - 1] for i in ids])
    nxt = np.stack([degraded[i + 1] for i in ids])
    deg = np.stack([degraded[i] for i in ids]).astype(np.float32)
    interp = pipe.interpolate(prev, nxt).float()  # (3, H, W) in 0..1
    interp1 = interp[..., None]

    x6 = gray6(torch.as_tensor(deg / 255.0, device=dev), interp)
    flow_ev = flows(flow_ev_model, x6)
    flow_bs = flows(flow_bs_model, x6)
    flow_gt = torch.stack([torch.as_tensor(gt[i]["flow2"], device=dev)
                           for i in ids])
    deg1 = nhwc(x6[:, 0:1]).contiguous()

    def warp1(flow):
        return spatial_transform(deg1, flow)

    outs = {}
    for name, flow in (("evalflow", flow_ev), ("bsflow", flow_bs),
                       ("gtflow", flow_gt)):
        warped = warp1(flow)
        outs[name] = dict(warped=to255(warped),
                          fused=to255(fuse(unet, warped, interp1)))

    # the unknown region in restored coordinates: the fold strip (mask 0)
    # carried through the GT unfolding warp; the warp can recover the rest
    unknown = np.stack([
        spatial_transform(
            torch.as_tensor(gt[i]["mask"], dtype=torch.float32,
                            device=dev)[None, ..., None],
            flow_gt[k:k + 1])[0, ..., 0].cpu().numpy() < 0.5
        for k, i in enumerate(ids)])

    flow_gt_np = flow_gt.cpu().numpy()
    epe = {}
    for name, flow in (("evalflow", flow_ev), ("bsflow", flow_bs)):
        e = np.linalg.norm(flow.cpu().numpy() - flow_gt_np, axis=-1)
        epe[name] = dict(overall=float(e.mean()),
                         on_strip=float(e[unknown].mean()),
                         off_strip=float(e[~unknown].mean()))

    gtc = np.stack([clean[i] for i in ids]).astype(np.float64)
    rows = {}

    def add(name, img255):
        rows[name] = dict(overall=psnr01(gtc, img255),
                          on_strip=psnr01(gtc, img255, unknown),
                          off_strip=psnr01(gtc, img255, ~unknown))

    add("degraded", deg)
    add("interp", interp.cpu().numpy().astype(np.float64) * 255.0)
    for name in ("evalflow", "bsflow", "gtflow"):
        add(f"warped[{name}]", outs[name]["warped"])
        add(f"fused[{name}]", outs[name]["fused"])
    rows["strip_fraction"] = float(unknown.mean())

    report = {"psnr": rows, "epe": epe, "root": args.root}

    if not args.no_curve:
        # fused PSNR at every fusion checkpoint
        curve = []
        models_root = os.path.dirname(stage["fusion_save"])
        for d in sorted(glob.glob(os.path.join(models_root, "*_q_fusion"))):
            for ck in sorted(glob.glob(os.path.join(d, "model-*.ckpt"))):
                net = load_model(lambda: UNetSFF(out_channel=1), ck)
                net = net.to(dev).eval()
                img = to255(fuse(net, warp1(flow_ev), interp1))
                curve.append(dict(dir=os.path.basename(d), iters=_step(ck),
                                  fused_psnr=psnr01(gtc, img),
                                  fused_on_strip=psnr01(gtc, img, unknown),
                                  fused_off_strip=psnr01(gtc, img, ~unknown)))
        report["curve"] = curve

        # flow EPE and off-strip warped PSNR at every unfolding checkpoint:
        # when the flow net becomes usable
        curve_u = []
        models_root = os.path.dirname(stage["unfold_save"])
        for d in sorted(glob.glob(os.path.join(models_root, "*_q_unfold"))):
            for ck in sorted(glob.glob(os.path.join(d, "model-*.ckpt"))):
                net = load_model(lambda: FusionNet(output_nc=2, ngf=32), ck)
                fl = flows(net.to(dev).eval(), x6)
                e = np.linalg.norm(fl.cpu().numpy() - flow_gt_np, axis=-1)
                w = to255(warp1(fl))
                curve_u.append(dict(
                    dir=os.path.basename(d), iters=_step(ck),
                    epe=float(e.mean()),
                    epe_off_strip=float(e[~unknown].mean()),
                    warped_off_strip_psnr=psnr01(gtc, w, ~unknown)))
        report["curve_unfold"] = curve_u

    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
