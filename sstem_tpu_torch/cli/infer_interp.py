"""SFF interp stack inference (counterpart of
``sstem_tpu/cli/infer_interp.py``; reference
``sff_scripts_interp/inference.py``): the damaged section ids come from
<input_path>/<txt_file>.txt, the sections are %04d.png in
<input_path>/<txt_file>/, and each damaged section k is interpolated from
sections k-1 and k+1 into <output_path>/<txt_file>_<model_id>/%04d.png;
'-m valid' scores each against the section it replaces (PSNR, SSIM) into
scores.txt there.

    python -m sstem_tpu_torch.cli.infer_interp -c CFG -ip DIR -t NAME \\
        -op OUT --ckpt IFNET_CKPT [-m valid] [--device cuda|cpu]
        [--packed-conv]

The checkpoint is a reference-format torch file, or a directory whose newest
``model-NNNNNN.ckpt`` is taken; the IFNet's kernel size is the config's
TRAIN.kernel_size and TEST.pad its symmetric pad. Reference quirk kept:
each prediction is written as (pred * 255).astype(uint8) without clipping.
``--packed-conv`` runs the fused-conv serving forward in bfloat16 (otherwise
float32 on cuDNN). It runs on the card unless ``--device cpu`` is given.
"""

import argparse
import os
import time

import numpy as np
import torch
from PIL import Image

from sstem_tpu_torch import metrics
from sstem_tpu_torch.cli._ckpt import load_model
from sstem_tpu_torch.compat.config import load_sff_config
from sstem_tpu_torch.config import (
    PARITY_DTYPE, SERVING_DTYPE, apply_matmul_precision,
)
from sstem_tpu_torch.infer.pipeline import SFFPipeline
from sstem_tpu_torch.models import IFNet


def score(pred, gt):
    """(PSNR, SSIM) of a uint8 prediction against its ground truth, as the
    reference scripts compute them (PSNR 1e12 for identical images)."""
    out = metrics.compute_psnr(pred, gt)
    psnr = 1e12 if not isinstance(out, tuple) else out[1]
    return psnr, metrics.compute_ssim(pred, gt)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--cfg", type=str, default="ms_l1loss_decay")
    parser.add_argument("-id", "--model_id", type=str, default="interp")
    parser.add_argument("-m", "--mode", type=str, default="valid")
    parser.add_argument("-ip", "--input_path", type=str,
                        default="../data/test/test_cremia/")
    parser.add_argument("-t", "--txt_file", type=str, default="cremia_25sff")
    parser.add_argument("-op", "--output_path", type=str,
                        default="../results/cremia/")
    parser.add_argument("--config-dir", type=str, default="./config")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="override ../trained_models/<id>/<id>.ckpt")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--packed-conv", action="store_true",
                        help="the fused-conv serving forward, bf16")
    args = parser.parse_args(argv)
    apply_matmul_precision()

    cfg = load_sff_config(args.cfg, args.config_dir)
    with open(os.path.join(args.input_path, args.txt_file + ".txt")) as f:
        img_list = [int(x) for x in f.read().split()]
    img_path = os.path.join(args.input_path, args.txt_file)
    output_path = os.path.join(args.output_path,
                               args.txt_file + "_" + args.model_id)
    os.makedirs(output_path, exist_ok=True)

    ckpt = args.ckpt or os.path.join("../trained_models", args.model_id,
                                     args.model_id + ".ckpt")
    interp = load_model(lambda: IFNet(cfg.TRAIN.kernel_size), ckpt)
    pipe = SFFPipeline(interp, None, None, device=args.device,
                       dtype=SERVING_DTYPE if args.packed_conv else PARITY_DTYPE,
                       pad=int(cfg.get("TEST", {}).get("pad", 0) or 0),
                       packed_conv=args.packed_conv)

    total_psnr, total_ssim = [], []
    t1 = time.time()
    with open(os.path.join(output_path, "scores.txt"), "w") as f_txt:
        for k in img_list:
            img1 = np.array(Image.open(
                os.path.join(img_path, str(k - 1).zfill(4) + ".png")))
            img2 = np.array(Image.open(
                os.path.join(img_path, str(k + 1).zfill(4) + ".png")))
            pred01 = pipe.interpolate(img1[None], img2[None],
                                      clip=False)[0].float().cpu().numpy()
            pred = (pred01 * 255).astype(np.uint8)
            Image.fromarray(pred).save(
                os.path.join(output_path, str(k).zfill(4) + ".png"))
            if args.mode == "valid":
                gt = np.asarray(Image.open(
                    os.path.join(img_path, str(k).zfill(4) + ".png")))
                psnr, ssim = score(pred, gt)
                total_psnr.append(psnr)
                total_ssim.append(ssim)
                line = "image=%d, PSNR=%.4f, SSIM=%.4f" % (k, psnr, ssim)
                print(line)
                f_txt.write(line + "\n")
        if args.mode == "valid" and total_psnr:
            line = "mean_PSNR=%.4f, mean_SSIM=%.4f" % (
                sum(total_psnr) / len(total_psnr),
                sum(total_ssim) / len(total_ssim))
            print(line)
            f_txt.write(line)
    if pipe.device.type == "cuda":
        torch.cuda.synchronize(pipe.device)
    print("COST TIME: ", time.time() - t1)


if __name__ == "__main__":
    main()
