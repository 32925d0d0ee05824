"""The conv3x3 kernel against the library conv (counterpart of
``tools/bench_conv3x3.py``).

    python -m sstem_tpu_torch.tools.bench_conv3x3 [--device cuda|cpu]

At the JAX tool's (C, size, batch) cases, C -> C with a ReLU on bf16 NHWC
activations and seeded weights: ``conv3x3_fused`` (identity affine) on its
prepared arguments, the JAX tool's "packed-kernel" (the port's kernel takes
NHWC as it is, so the tool's pack-and-unpack "e2e" has no counterpart), and
``F.conv2d`` + ReLU on the same values as channels-last tensors, the
tool's "xla". Each side's ms per section and GB/s (one read of the input
and one write of the output, as the JAX tool counts them), and the largest
difference between the two outputs.

CUDA events on the card (the host clock only with ``--device cpu``), mean
of 8 calls after 14 warm ones. Without a card and without ``--device
cpu`` it prints one error line and exits 2.
"""

import argparse
import sys

import torch
import torch.nn.functional as F

from sstem_tpu_torch.tools._timing import card_missing, generator, seconds

# (C, size, batch), the JAX tool's (tools/bench_conv3x3.py:39-40)
CASES = ((32, 1280, 4), (64, 1280, 4), (64, 640, 4), (128, 640, 4))


def row_name(c, hw):
    """The JAX tool's row label (tools/bench_conv3x3.py:82)."""
    return f"C{c:3d} @{hw}"


@torch.inference_mode()
def bench_conv3x3(device="cuda", size=1280, iters=8, warm=14, seed=0):
    """Returns {row: {"kernel_ms", "kernel_gb_per_s", "library_ms",
    "library_gb_per_s", "max_err"}} for ``CASES``, ms per section, printing
    each row. ``size`` stands for the cases' 1280 (640 scales with it);
    the rows keep the JAX tool's labels."""
    from sstem_tpu_torch.kernels import conv3x3_fused, fold_affine

    gen = generator(device, seed)
    rows = {}
    for c, hw, n in CASES:
        s = hw * size // 1280
        x = torch.randn((n, s, s, c), generator=gen, device=device).to(
            torch.bfloat16)
        w = (torch.randn((3, 3, c, c), generator=gen, device=device)
             / (3 * c ** 0.5)).to(torch.bfloat16)
        scale, shift = fold_affine(c)
        scale, shift = scale.to(device), shift.to(device)
        xc = x.permute(0, 3, 1, 2)  # channels-last view
        wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

        def kernel():
            return conv3x3_fused(x, w, scale, shift, "relu")

        def library():
            return torch.relu(F.conv2d(xc, wc, padding=1))

        err = float((kernel().float() - library().permute(0, 2, 3, 1).float())
                    .abs().max())
        dt_k = seconds(kernel, device, iters, warm)
        dt_x = seconds(library, device, iters, warm)
        gb = 2 * 2 * n * s * s * c / 1e9
        row = rows[row_name(c, hw)] = {
            "kernel_ms": dt_k * 1e3 / n, "kernel_gb_per_s": gb / dt_k,
            "library_ms": dt_x * 1e3 / n, "library_gb_per_s": gb / dt_x,
            "max_err": err}
        print(f"{row_name(c, hw)}: kernel {row['kernel_ms']:6.2f} ms/sec "
              f"({row['kernel_gb_per_s']:5.1f} GB/s)  cudnn "
              f"{row['library_ms']:6.2f} ({row['library_gb_per_s']:5.1f} "
              f"GB/s)  maxerr {err:.3e}", flush=True)
        del x, xc
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if card_missing("bench_conv3x3", args.device):
        return 2
    bench_conv3x3(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
