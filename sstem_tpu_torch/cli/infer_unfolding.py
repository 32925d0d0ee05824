"""SFF unfolding inference (counterpart of
``sstem_tpu/cli/infer_unfolding.py``; reference
``sff_scripts_unfolding/inference.py``): for each damaged section k of
<input_path>/<txt_file>.txt, the degraded section <txt_file>/%04d.png and
its interp image (<interp-dir>/%04d.png) go through the flow net
(FusionNet), and the degraded section is warped by the flow
(``kernels.serving_warp``). It writes the unfolded section and the
Middlebury rendering of the flow as %04d.png in
<output_path>/<txt_file>_<model_id> and its ``_flow`` folder; '-m valid'
reads the ground-truth flow2 from <txt_file>/%04d_flow.hdf (h5py) and the
clean section from %04d_gt.png, and scores EPE, PSNR and SSIM into
scores.txt. The average flow and warp times per section are printed.

    python -m sstem_tpu_torch.cli.infer_unfolding -c CFG -ip DIR -t NAME \\
        -op OUT --ckpt FLOW_CKPT [--interp-dir DIR] [-m valid|test]
        [--device cuda|cpu]

The checkpoint is a reference-format torch file or a directory of
``model-NNNNNN.ckpt``; the FusionNet's width is the config's TRAIN.ngf. The
FlowNetC/FlowNetS backbones the reference scripts import do not exist in
the reference repo; selecting them stops with the same message as the JAX
CLI. It runs float32 on the card unless ``--device cpu`` is given.
"""

import argparse
import os
import time

import numpy as np
import torch
from PIL import Image

from sstem_tpu_torch import losses
from sstem_tpu_torch.cli._ckpt import load_model
from sstem_tpu_torch.cli.infer_interp import score
from sstem_tpu_torch.compat.config import load_sff_config
from sstem_tpu_torch.config import apply_matmul_precision
from sstem_tpu_torch.infer.tiles import pad_to_multiple
from sstem_tpu_torch.kernels import serving_warp
from sstem_tpu_torch.models import FusionNet
from sstem_tpu_torch.ops.flow_display import dense_flow


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--cfg", type=str,
                        default="sff_flowfusionnet_L1_lr0001decay")
    parser.add_argument("-id", "--model_id", type=str,
                        default="unfolding_fusionnet")
    parser.add_argument("-m", "--mode", type=str, default="valid")
    parser.add_argument("-ip", "--input_path", type=str,
                        default="../data/test/test_cremic/")
    parser.add_argument("-t", "--txt_file", type=str, default="cremic_25sff")
    parser.add_argument("-op", "--output_path", type=str,
                        default="../results/cremic")
    parser.add_argument("--interp-dir", type=str, default=None,
                        help="dir of interp-stage outputs (default "
                             "<op>/<txt>_interp)")
    parser.add_argument("--config-dir", type=str, default="./config")
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    apply_matmul_precision()

    if "flownet" in args.model_id.lower() and "fusionnet" not in args.model_id:
        raise SystemExit(
            "FlowNetC/FlowNetS backbones are referenced by the original "
            "scripts but their model files do not exist in the repo; only "
            "the FusionNet flow backbone is supported."
        )

    cfg = load_sff_config(args.cfg, args.config_dir)
    device = torch.device(args.device)
    ckpt = args.ckpt or os.path.join(
        "../trained_models", args.model_id, args.model_id + ".ckpt")
    flow_model = load_model(lambda: FusionNet(ngf=cfg.TRAIN.ngf), ckpt)
    flow_model = flow_model.to(device).eval()

    with open(os.path.join(args.input_path, args.txt_file + ".txt")) as f:
        img_list = [int(x) for x in f.read().split()]
    img_path = os.path.join(args.input_path, args.txt_file)
    interp_dir = args.interp_dir or os.path.join(
        args.output_path, args.txt_file + "_interp")
    out_img = os.path.join(args.output_path,
                           args.txt_file + "_" + args.model_id)
    out_flow = out_img + "_flow"
    os.makedirs(out_img, exist_ok=True)
    os.makedirs(out_flow, exist_ok=True)

    total = {"epe": [], "psnr": [], "ssim": []}
    times = {"flow": [], "warp": []}
    with open(os.path.join(out_img, "scores.txt"), "w") as f_txt, \
            torch.inference_mode():
        for k in img_list:
            name = str(k).zfill(4)
            deg = np.array(Image.open(os.path.join(img_path, name + ".png")))
            interp = np.array(Image.open(
                os.path.join(interp_dir, name + ".png")))
            deg01 = torch.from_numpy(deg).to(device).float() / 255.0
            interp01 = torch.from_numpy(interp).to(device).float() / 255.0
            x = torch.stack([deg01] * 3 + [interp01] * 3, dim=-1)[None]
            x, (h, w) = pad_to_multiple(x, 16)
            _sync(device)
            t0 = time.time()
            flow = flow_model(x.permute(0, 3, 1, 2)).float()
            flow = flow.permute(0, 2, 3, 1)[:, :h, :w].contiguous()
            _sync(device)
            t1 = time.time()
            warped = serving_warp(deg01[None, :, :, None].contiguous(), flow)
            warped = warped[0, :, :, 0].clamp(0, 1).cpu().numpy()
            t2 = time.time()
            times["flow"].append(t1 - t0)
            times["warp"].append(t2 - t1)
            flow_np = flow[0].cpu().numpy()
            warped8 = (warped * 255).astype(np.uint8)
            Image.fromarray(warped8).save(os.path.join(out_img, name + ".png"))
            Image.fromarray(dense_flow(flow_np)).save(
                os.path.join(out_flow, name + ".png"))

            if args.mode == "valid":
                import h5py

                with h5py.File(os.path.join(img_path, name + "_flow.hdf"),
                               "r") as hf:
                    gt_flow = np.asarray(hf["flow2"], np.float32)
                epe = float(losses.epe(torch.from_numpy(flow_np[None]),
                                       torch.from_numpy(gt_flow[None])))
                gt_img = np.asarray(Image.open(
                    os.path.join(img_path, name + "_gt.png")))
                psnr, ssim = score(warped8, gt_img)
                total["epe"].append(epe)
                total["psnr"].append(psnr)
                total["ssim"].append(ssim)
                line = "image=%d, EPE=%.4f, PSNR=%.4f, SSIM=%.4f" % (
                    k, epe, psnr, ssim)
                print(line)
                f_txt.write(line + "\n")
        if args.mode == "valid" and total["epe"]:
            line = "mean_EPE=%.4f, mean_PSNR=%.4f, mean_SSIM=%.4f" % (
                np.mean(total["epe"]), np.mean(total["psnr"]),
                np.mean(total["ssim"]))
            print(line)
            f_txt.write(line)
    print("average flow time: %f" % np.mean(times["flow"]))
    print("average warp time: %f" % np.mean(times["warp"]))


if __name__ == "__main__":
    main()
