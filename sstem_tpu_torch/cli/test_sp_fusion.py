"""SP quartet restore test CLI (counterpart of
``sstem_tpu/cli/test_sp_fusion.py``; reference
``sp_scripts_test/test_fusion.py``): interp + denoise + mask blend + fusion
of sections 2 and 3 of a quartet; writes ``pred1.png`` and ``pred2.png``.

    python -m sstem_tpu_torch.cli.test_sp_fusion -dp DIR -im1 1.png \\
        -im2d 2.png -im2m 2m.png -im3d 3.png -im3m 3m.png -im4 4.png \\
        -sp OUT (-mp MODELS | --vfi A --denoise B --fusion C) \\
        [--device cuda|cpu] [--packed-conv] [--kernel-size 51]

Checkpoints are reference-format torch files: ``-mp MODELS`` names a
directory holding ``vfi``, ``denoise`` and ``fusion`` (each a checkpoint
file or a directory of ``model-NNNNNN.ckpt``), or ``--vfi``, ``--denoise``
and ``--fusion`` name them one by one. ``--packed-conv`` runs the U-Nets'
fused-conv serving forwards in bfloat16 (otherwise everything runs in
float32). It runs on the card unless ``--device cpu`` is given.
"""

import argparse
import os
import time

import torch

from sstem_tpu_torch.cli._ckpt import load_model
from sstem_tpu_torch.cli._sp import read_gray, write_png
from sstem_tpu_torch.config import (
    PARITY_DTYPE, SERVING_DTYPE, apply_matmul_precision,
)
from sstem_tpu_torch.infer.pipeline import SPPipeline
from sstem_tpu_torch.models import FusionNetSP, IFNet, UNetSP


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-mp", "--model_path", default=None)
    parser.add_argument("--vfi", default=None)
    parser.add_argument("--denoise", default=None)
    parser.add_argument("--fusion", default=None)
    parser.add_argument("-dp", "--input_data_path", required=True)
    parser.add_argument("-im1", "--img1", required=True)
    parser.add_argument("-im2d", "--im2_degra", required=True)
    parser.add_argument("-im2m", "--im2_mask", required=True)
    parser.add_argument("-im3d", "--im3_degra", required=True)
    parser.add_argument("-im3m", "--im3_mask", required=True)
    parser.add_argument("-im4", "--img4", required=True)
    parser.add_argument("-sp", "--save_path", required=True)
    parser.add_argument("-mGPU", "--if_multi_gpu", default=None)
    parser.add_argument("--kernel-size", type=int, default=51)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--packed-conv", action="store_true",
                        help="the U-Nets' fused-conv serving forwards, bf16")
    args = parser.parse_args(argv)
    apply_matmul_precision()

    paths = {}
    for name in ("vfi", "denoise", "fusion"):
        paths[name] = getattr(args, name) or (
            args.model_path and os.path.join(args.model_path, name))
        if not paths[name]:
            parser.error(f"give -mp or --{name}")

    t0 = time.time()
    pipe = SPPipeline(
        load_model(lambda: IFNet(args.kernel_size, n_frames=2), paths["vfi"]),
        load_model(UNetSP, paths["denoise"]),
        load_model(FusionNetSP, paths["fusion"]),
        device=args.device,
        dtype=SERVING_DTYPE if args.packed_conv else PARITY_DTYPE,
        packed_conv=args.packed_conv)
    dp = args.input_data_path
    out = pipe.restore(read_gray(dp, args.img1), read_gray(dp, args.img4),
                       read_gray(dp, args.im2_degra), read_gray(dp, args.im3_degra),
                       read_gray(dp, args.im2_mask), read_gray(dp, args.im3_mask))
    write_png(args.save_path, "pred1.png", out["pred1"][0].cpu().numpy())
    write_png(args.save_path, "pred2.png", out["pred2"][0].cpu().numpy())
    if pipe.device.type == "cuda":
        torch.cuda.synchronize(pipe.device)
    print("It takes %fs for processing" % (time.time() - t0))


if __name__ == "__main__":
    main()
