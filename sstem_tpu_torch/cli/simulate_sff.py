"""Offline SFF simulator CLI (counterpart of ``sstem_tpu/cli/simulate_sff.py``;
reference ``simu_sff/simuSFF.py``): degrade each PNG in a folder with a
random support-film fold, saving ``*_SimuSFF.png`` plus a Middlebury
rendering of the synthesis flow (``*_SimuSFF_flow.png``).

    python -m sstem_tpu_torch.cli.simulate_sff -p DIR [-s 1024] [-o OUT]
        [--seed 0] [--no-noise]

Host code (numpy, and the warp's plain PyTorch version on the CPU); the
same seed writes the same files as the JAX CLI.
"""

import argparse
import os

import numpy as np
from PIL import Image

from sstem_tpu_torch.config import apply_matmul_precision
from sstem_tpu_torch.data.sim_sff import SimuSFF
from sstem_tpu_torch.ops.flow_display import dense_flow


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-p", "--path", required=True,
                        help="folder of clean PNG sections")
    parser.add_argument("-s", "--size", type=int, default=1024)
    parser.add_argument("-o", "--output", default=None,
                        help="output folder (default: input folder)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-noise", action="store_true")
    args = parser.parse_args(argv)
    apply_matmul_precision()

    out_dir = args.output or args.path
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    sim = SimuSFF(size=args.size, apply_noise=not args.no_noise)

    for name in sorted(os.listdir(args.path)):
        if not name.endswith(".png") or name.endswith("_SimuSFF.png"):
            continue
        img = np.asarray(Image.open(os.path.join(args.path, name)))
        if img.ndim == 3:
            img = img[:, :, 0]
        if min(img.shape) < args.size:
            print("skip %s (smaller than %d)" % (name, args.size))
            continue
        degraded, flow, mask = sim(img, rng)
        stem = name[:-4]
        Image.fromarray(degraded).save(
            os.path.join(out_dir, stem + "_SimuSFF.png"))
        Image.fromarray(dense_flow(flow)).save(
            os.path.join(out_dir, stem + "_SimuSFF_flow.png"))
        print("degraded", name)


if __name__ == "__main__":
    main()
