"""SP interp test CLI (counterpart of ``sstem_tpu/cli/test_sp_interp.py``;
reference ``sp_scripts_test/test_interp.py``): predicts sections 2 and 3 of a
quartet from sections 1 and 4 and writes ``vfi_1.png`` and ``vfi_2.png``.

    python -m sstem_tpu_torch.cli.test_sp_interp -mp vfi.ckpt -dp DIR \\
        -im1 1.png -im2 4.png -sp OUT [--device cuda|cpu] [--kernel-size 51]

``-mp`` is a reference-format torch checkpoint (or a directory of
``model-NNNNNN.ckpt``). Inputs are padded to a multiple of 32 and cropped
back. It runs on the card unless ``--device cpu`` is given.
"""

import argparse
import time

import torch

from sstem_tpu_torch.cli._ckpt import load_model
from sstem_tpu_torch.cli._sp import read_gray, write_png
from sstem_tpu_torch.config import apply_matmul_precision
from sstem_tpu_torch.infer.pipeline import SPPipeline
from sstem_tpu_torch.models import IFNet


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-mp", "--model_path", required=True)
    parser.add_argument("-dp", "--input_data_path", required=True)
    parser.add_argument("-im1", "--input_img1", required=True)
    parser.add_argument("-im2", "--input_img2", required=True)
    parser.add_argument("-sp", "--save_path", required=True)
    parser.add_argument("-mGPU", "--if_multi_gpu", default=None)
    parser.add_argument("--kernel-size", type=int, default=51)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    apply_matmul_precision()

    t0 = time.time()
    vfi = load_model(lambda: IFNet(args.kernel_size, n_frames=2),
                     args.model_path)
    pipe = SPPipeline(vfi, device=args.device)
    pred = pipe.interp(read_gray(args.input_data_path, args.input_img1),
                       read_gray(args.input_data_path, args.input_img2))
    pred = pred[0].cpu().numpy()
    write_png(args.save_path, "vfi_1.png", pred[:, :, 0])
    write_png(args.save_path, "vfi_2.png", pred[:, :, 1])
    if pipe.device.type == "cuda":
        torch.cuda.synchronize(pipe.device)
    print("It takes %fs for processing" % (time.time() - t0))


if __name__ == "__main__":
    main()
