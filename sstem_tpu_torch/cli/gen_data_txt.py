"""Data-list writers (counterpart of ``sstem_tpu/cli/gen_data_txt.py``), in
both reference dialects (sff_scripts_interp/gen_data_txt.py and
sp_scripts_train/gen_data_txt.py):

    python -m sstem_tpu_torch.cli.gen_data_txt -f DIR [-n 4000]
        [--dialect sff|sp]

``sff`` writes ``train_data.txt`` triplet rows, ``sp`` the 12-column
``sp_train_data.txt`` of ``providers.write_sp_txt``.
"""

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-f", "--folder", required=True)
    parser.add_argument("-n", "--num", type=int, default=4000)
    parser.add_argument("--dialect", choices=["sff", "sp"], default="sff")
    args = parser.parse_args(argv)
    from sstem_tpu_torch.config import apply_matmul_precision

    apply_matmul_precision()

    if args.dialect == "sff":
        path = os.path.join(args.folder, "train_data.txt")
        with open(path, "w") as f:
            for i in range(args.num):
                stem = str(i).zfill(4)
                f.write(f"{stem}_1.png {stem}_2.png {stem}_3.png\n")
    else:
        from sstem_tpu_torch.data.providers import write_sp_txt

        write_sp_txt(args.folder, args.num)
        path = os.path.join(args.folder, "sp_train_data.txt")
    print("wrote", path)


if __name__ == "__main__":
    main()
