"""Single-pair interpolation (counterpart of
``sstem_tpu/cli/infer_interp_single.py``; reference
``inference_singleImage.py``): the section between two gray PNGs.

    python -m sstem_tpu_torch.cli.infer_interp_single -c CFG -i1 A.png \\
        -i2 B.png -o OUT.png [--ckpt IFNET_CKPT] [--device cuda|cpu]

The checkpoint is a reference-format torch file, or a directory whose newest
``model-NNNNNN.ckpt`` is taken; the IFNet's kernel size is the config's
TRAIN.kernel_size and TEST.pad its symmetric pad. Reference quirk kept: the
prediction is written as (pred * 255).astype(uint8) without clipping. It
runs float32 on the card unless ``--device cpu`` is given.
"""

import argparse
import os

import numpy as np
from PIL import Image

from sstem_tpu_torch.cli._ckpt import load_model
from sstem_tpu_torch.compat.config import load_sff_config
from sstem_tpu_torch.config import apply_matmul_precision
from sstem_tpu_torch.infer.pipeline import SFFPipeline
from sstem_tpu_torch.models import IFNet


def interp_pipeline(cfg, ckpt, device):
    """The interp stage alone, float32, from a reference-format checkpoint
    (shared with ``infer_interp_trainingset``)."""
    interp = load_model(lambda: IFNet(cfg.TRAIN.kernel_size), ckpt)
    return SFFPipeline(interp, None, None, device=device,
                       pad=int(cfg.get("TEST", {}).get("pad", 0) or 0))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--cfg", type=str, default="ms_l1loss_decay")
    parser.add_argument("-id", "--model_id", type=str, default="interp")
    parser.add_argument("-i1", "--img1", type=str, required=True)
    parser.add_argument("-i2", "--img2", type=str, required=True)
    parser.add_argument("-o", "--output", type=str, required=True)
    parser.add_argument("--config-dir", type=str, default="./config")
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    apply_matmul_precision()

    cfg = load_sff_config(args.cfg, args.config_dir)
    ckpt = args.ckpt or os.path.join("../trained_models", args.model_id,
                                     args.model_id + ".ckpt")
    pipe = interp_pipeline(cfg, ckpt, args.device)
    img1 = np.array(Image.open(args.img1))
    img2 = np.array(Image.open(args.img2))
    pred = pipe.interpolate(img1[None], img2[None], clip=False)[0]
    Image.fromarray((pred.cpu().numpy() * 255).astype(np.uint8)).save(
        args.output)
    print("saved", args.output)


if __name__ == "__main__":
    main()
