"""SFF flow and fusion inference (counterpart of
``sstem_tpu/cli/infer_fusion.py``; reference
``sff_scripts_fusion/inference.py``): for each damaged section k of
<input_path>/<txt_file>.txt, the degraded section and the interp stage's
output (<interp-dir>/%04d.png) go through the unfolding flow (FusionNet),
the warp and the fusion U-Net (UNetSFF). It writes the fused section, the
stitching composite and the Middlebury rendering of the flow, each as
%04d.png in <output_path>/<txt_file>_<model_id>[_GFcorrect], its
``_stitching`` and its ``_flow`` folder; '-m valid' scores the fused
sections (PSNR, SSIM) into scores.txt; the average inference time per
section is printed.

    python -m sstem_tpu_torch.cli.infer_fusion -c CFG -ip DIR -t NAME \\
        -op OUT --ckpt FUSION_CKPT --flow-ckpt FLOW_CKPT [--interp-dir DIR]
        [--with-inputs] [-m valid] [--device cuda|cpu] [--packed-conv]

``--with-inputs`` reads externally corrected inputs (%04d_GFcorrect.png,
the reference's ``inference_fusion_wInputs.py``). Checkpoints are
reference-format torch files or directories of ``model-NNNNNN.ckpt``; the
FusionNet's width is the config's TRAIN.ngf. ``--packed-conv`` runs the
fused-conv serving forwards in bfloat16 (otherwise float32 on cuDNN). It
runs on the card unless ``--device cpu`` is given.
"""

import argparse
import os
import time

import numpy as np
import torch
from PIL import Image

from sstem_tpu_torch.cli._ckpt import load_model
from sstem_tpu_torch.cli.infer_interp import score
from sstem_tpu_torch.compat.config import load_sff_config
from sstem_tpu_torch.config import (
    PARITY_DTYPE, SERVING_DTYPE, apply_matmul_precision,
)
from sstem_tpu_torch.infer.pipeline import SFFPipeline
from sstem_tpu_torch.models import FusionNet, UNetSFF
from sstem_tpu_torch.ops.flow_display import dense_flow


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--cfg", type=str,
                        default="sff_fusion_L1_lr0001decay")
    parser.add_argument("-id", "--model_id", type=str, default="fusion")
    parser.add_argument("-fm", "--flow_model", type=str,
                        default="unfolding_fusionnet")
    parser.add_argument("-m", "--mode", type=str, default="valid")
    parser.add_argument("-ip", "--input_path", type=str,
                        default="../data/test/test_cremic/")
    parser.add_argument("-t", "--txt_file", type=str, default="cremic_25sff")
    parser.add_argument("-op", "--output_path", type=str,
                        default="../results/cremic")
    parser.add_argument("--with-inputs", action="store_true",
                        help="read externally corrected *_GFcorrect inputs "
                             "(inference_fusion_wInputs.py)")
    parser.add_argument("--interp-dir", type=str, default=None)
    parser.add_argument("--config-dir", type=str, default="./config")
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--flow-ckpt", type=str, default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--packed-conv", action="store_true",
                        help="the fused-conv serving forwards, bf16")
    args = parser.parse_args(argv)
    apply_matmul_precision()

    if "flownet" in args.flow_model.lower() and \
            "fusionnet" not in args.flow_model:
        raise SystemExit(
            "FlowNetC/FlowNetS are referenced by the original scripts but "
            "absent from the repo; only the FusionNet flow backbone exists.")

    cfg = load_sff_config(args.cfg, args.config_dir)
    flow_ckpt = args.flow_ckpt or os.path.join(
        "../trained_models", args.flow_model, args.flow_model + ".ckpt")
    fusion_ckpt = args.ckpt or os.path.join(
        "../trained_models", args.model_id, args.model_id + ".ckpt")
    pipe = SFFPipeline(
        None, load_model(lambda: FusionNet(ngf=cfg.TRAIN.ngf), flow_ckpt),
        load_model(UNetSFF, fusion_ckpt), device=args.device,
        dtype=SERVING_DTYPE if args.packed_conv else PARITY_DTYPE,
        packed_conv=args.packed_conv)

    with open(os.path.join(args.input_path, args.txt_file + ".txt")) as f:
        img_list = [int(x) for x in f.read().split()]
    sff_path = os.path.join(args.input_path, args.txt_file)
    interp_dir = args.interp_dir or os.path.join(
        args.output_path, args.txt_file + "_interp")
    suffix = "_GFcorrect" if args.with_inputs else ""
    fusion_path = os.path.join(
        args.output_path, args.txt_file + "_" + args.model_id + suffix)
    flow_path = fusion_path + "_flow"
    stitch_path = fusion_path + "_stitching"
    for p in (fusion_path, flow_path, stitch_path):
        os.makedirs(p, exist_ok=True)

    total_psnr, total_ssim, pred_time = [], [], []
    t_start = time.time()
    with open(os.path.join(fusion_path, "scores.txt"), "w") as f_txt:
        for k in img_list:
            name = str(k).zfill(4) + suffix + ".png"
            sff = np.array(Image.open(os.path.join(sff_path, name)))
            interp = np.array(Image.open(
                os.path.join(interp_dir, str(k).zfill(4) + ".png")))
            t0 = time.time()
            out = pipe.restore(sff[None], interp[None])
            # the host pull waits for the device
            pred = (out["fused"][0].cpu().numpy() * 255).astype(np.uint8)
            pred_time.append(time.time() - t0)
            stitch = (out["stitch"][0].cpu().numpy() * 255).astype(np.uint8)
            flow_np = out["flow"][0].cpu().numpy()
            Image.fromarray(pred).save(os.path.join(fusion_path,
                                                    str(k).zfill(4) + ".png"))
            Image.fromarray(stitch).save(
                os.path.join(stitch_path, str(k).zfill(4) + ".png"))
            Image.fromarray(dense_flow(flow_np)).save(
                os.path.join(flow_path, str(k).zfill(4) + ".png"))
            if args.mode == "valid":
                gt = np.asarray(Image.open(
                    os.path.join(args.input_path, args.txt_file,
                                 str(k).zfill(4) + ".png")))
                psnr, ssim = score(pred, gt)
                total_psnr.append(psnr)
                total_ssim.append(ssim)
                line = "image=%d, PSNR=%.4f, SSIM=%.4f" % (k, psnr, ssim)
                print(line)
                f_txt.write(line + "\n")
        if args.mode == "valid" and total_psnr:
            line = "mean_PSNR=%.4f, mean_SSIM=%.4f" % (
                np.mean(total_psnr), np.mean(total_ssim))
            print(line)
            f_txt.write(line + "\n")
    if pipe.device.type == "cuda":
        torch.cuda.synchronize(pipe.device)
    print("average inference time: %f" % np.mean(pred_time))
    print("COST TIME: ", time.time() - t_start)


if __name__ == "__main__":
    main()
