"""Build an unfolding/fusion validation set (degraded + interp + GT flow
HDF5 sidecars) from a triplet data tree (counterpart of
``sstem_tpu/cli/make_validset.py``; see ``sstem_tpu_torch/data/validset.py``).

    python -m sstem_tpu_torch.cli.make_validset -f DATA -o OUT
        [-t train_data.txt] [--interp-txt interp_train_data.txt]
        [--crop 400] [--det 256] [--seed 0]

Needs h5py for the flow sidecars.
"""

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-f", "--folder", required=True)
    parser.add_argument("-t", "--train-txt", default="train_data.txt")
    parser.add_argument("--interp-txt", default=None,
                        help="optional interp_train_data.txt")
    parser.add_argument("-o", "--out", required=True)
    parser.add_argument("--crop", type=int, default=400)
    parser.add_argument("--det", type=int, default=256)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    from sstem_tpu_torch.config import apply_matmul_precision

    apply_matmul_precision()

    from sstem_tpu_torch.data.validset import make_unfolding_validset

    with open(os.path.join(args.folder, args.train_txt)) as f:
        rows = [r.split() for r in f.read().splitlines() if r.strip()]
    interp_names = None
    if args.interp_txt:
        with open(os.path.join(args.folder, args.interp_txt)) as f:
            interp_names = [r.strip() for r in f if r.strip()]

    out_rows = make_unfolding_validset(
        args.folder, args.out, rows, interp_names,
        crop=args.crop, det=args.det, seed=args.seed,
    )
    print("wrote %d valid items to %s" % (len(out_rows), args.out))


if __name__ == "__main__":
    main()
