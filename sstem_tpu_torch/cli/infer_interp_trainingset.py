"""Interp over the training triplet list (counterpart of
``sstem_tpu/cli/infer_interp_trainingset.py``; reference
``inference_trainingset.py``): for each row of DATA.train_txt, the section
between its first and third image, written as
<folder>/interp_train_data/%04d.png, and the list of those names as
<folder>/interp_train_data.txt. The unfolding and fusion trainers read both
(DATA.interp_train_txt).

    python -m sstem_tpu_torch.cli.infer_interp_trainingset -c CFG \\
        [--ckpt IFNET_CKPT] [-bs N] [--device cuda|cpu]

``-bs`` interpolates N rows a call (the images must share a size).
Checkpoints and the written values are as in ``infer_interp_single``. It
runs float32 on the card unless ``--device cpu`` is given.
"""

import argparse
import os

import numpy as np
from PIL import Image

from sstem_tpu_torch.cli.infer_interp_single import interp_pipeline
from sstem_tpu_torch.compat.config import load_sff_config
from sstem_tpu_torch.config import apply_matmul_precision


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--cfg", type=str, default="ms_l1loss_decay")
    parser.add_argument("-id", "--model_id", type=str, default="interp")
    parser.add_argument("-bs", "--batch_size", type=int, default=1)
    parser.add_argument("--config-dir", type=str, default="./config")
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    apply_matmul_precision()

    cfg = load_sff_config(args.cfg, args.config_dir)
    folder = cfg.DATA.folder_name
    with open(os.path.join(folder, cfg.DATA.train_txt)) as f:
        rows = [r.split() for r in f.read().splitlines() if r.strip()]
    ckpt = args.ckpt or os.path.join("../trained_models", args.model_id,
                                     args.model_id + ".ckpt")
    pipe = interp_pipeline(cfg, ckpt, args.device)

    def read(name):
        return np.asarray(Image.open(os.path.join(folder, name)))

    out_dir = os.path.join(folder, "interp_train_data")
    os.makedirs(out_dir, exist_ok=True)
    names = []
    bs = args.batch_size
    for s in range(0, len(rows), bs):
        chunk = rows[s:s + bs]
        img1 = np.stack([read(r[0]) for r in chunk])
        img3 = np.stack([read(r[2]) for r in chunk])
        preds = pipe.interpolate(img1, img3, clip=False).float().cpu().numpy()
        for j in range(len(chunk)):
            name = os.path.join("interp_train_data", "%04d.png" % (s + j))
            Image.fromarray((preds[j] * 255).astype(np.uint8)).save(
                os.path.join(folder, name))
            names.append(name)
    with open(os.path.join(folder, "interp_train_data.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    print("wrote %d interp images" % len(names))


if __name__ == "__main__":
    main()
