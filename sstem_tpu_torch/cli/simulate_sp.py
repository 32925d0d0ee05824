"""Offline SP simulator CLI (counterpart of ``sstem_tpu/cli/simulate_sp.py``;
reference ``simu_sp/simu_sp.py``): degrade each PNG with stain-precipitate
blobs from a mask bank, saving ``*_degra.png``, ``*_degra_maska.png``,
``*_degra_maskb.png`` (the names ``providers.write_sp_txt``'s rows and
``SPDataset`` read).

    python -m sstem_tpu_torch.cli.simulate_sp -p DIR [-o OUT]
        (--synthetic-bank N | --mask-root M --mask10-root M10
         --mask01-root M01) [--num-draws 1000] [--seed 0]

The mask bank is either the published layout (--mask-root/--mask10-root/
--mask01-root triples) or ``--synthetic-bank N`` (random-blob bank; lets the
full pipeline run without the external download)."""

import argparse
import os

import numpy as np
from PIL import Image

from sstem_tpu_torch.config import apply_matmul_precision
from sstem_tpu_torch.data.sim_sp import MaskBank, simu_sp


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-p", "--path", required=True)
    parser.add_argument("-o", "--output", default=None)
    parser.add_argument("--mask-root", default=None)
    parser.add_argument("--mask10-root", default=None)
    parser.add_argument("--mask01-root", default=None)
    parser.add_argument("--synthetic-bank", type=int, default=0)
    parser.add_argument("--num-draws", type=int, default=1000)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    apply_matmul_precision()

    if args.synthetic_bank:
        bank = MaskBank.synthetic(n=args.synthetic_bank, seed=args.seed)
    else:
        if not (args.mask_root and args.mask10_root and args.mask01_root):
            parser.error("provide the mask bank dirs or --synthetic-bank N")
        bank = MaskBank.from_dirs(args.mask_root, args.mask10_root,
                                  args.mask01_root)
    print("mask bank size:", len(bank))

    out_dir = args.output or args.path
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    for name in sorted(os.listdir(args.path)):
        if not name.endswith(".png") or "_degra" in name:
            continue
        img = np.asarray(Image.open(os.path.join(args.path, name)))
        degra, maska, maskb = simu_sp(img, bank, rng,
                                      num_draws=args.num_draws)
        stem = name[:-4]
        Image.fromarray(degra).save(
            os.path.join(out_dir, stem + "_degra.png"))
        Image.fromarray(maska).save(
            os.path.join(out_dir, stem + "_degra_maska.png"))
        Image.fromarray(maskb).save(
            os.path.join(out_dir, stem + "_degra_maskb.png"))
        print("degraded", name)


if __name__ == "__main__":
    main()
