"""Micro-benchmark of the sepconv forward (counterpart of
``tools/micro_bench.py --which sepconv``).

    python -m sstem_tpu_torch.tools.micro_bench [--which sepconv]
        [--size 1280] [--iters 10] [--device cuda|cpu]

At 1 x 1 x size^2, K=51, float32 (the JAX tool's shape), two times:

  * "kernel only": ``sepconv_planar`` on an image already replication-padded
    and planar, and planar maps, which is what the JAX tool's
    ``kernel_only`` meant to time;
  * "incl prep": the replication pad of the (1, 1, size, size) image, its
    cast to float32 and the kernel.

The JAX tool's conv and layout sections time XLA convolutions only (no
kernel of the repository) and its warp section the XLA gather; they are
not ported.
"""

import argparse
import sys

import torch

from sstem_tpu_torch.kernels import sepconv_planar
from sstem_tpu_torch.ops import replication_pad_2d
from sstem_tpu_torch.tools._timing import generator, seconds

K = 51
PORTED = ("sepconv", "all")


def sepconv_bench(device="cuda", size=1280, iters=10, k=K, seed=0):
    """Returns {'kernel only': ms, 'incl prep': ms}."""
    gen = generator(device, seed)
    image = torch.randn((1, 1, size, size), generator=gen, device=device)
    v = torch.randn((1, k, size, size), generator=gen, device=device) / k
    h = torch.randn((1, k, size, size), generator=gen, device=device) / k
    padded = replication_pad_2d(image, k // 2).contiguous()

    def prep_and_kernel():
        im = replication_pad_2d(image, k // 2).to(torch.float32).contiguous()
        return sepconv_planar(im, v, h)

    out = {}
    for name, fn in (("kernel only", lambda: sepconv_planar(padded, v, h)),
                     ("incl prep", prep_and_kernel)):
        out[name] = seconds(fn, device, iters, warm=2) * 1e3
        print(f"sepconv fwd K={k} 1x1x{size}^2 f32 {name:12s} "
              f"{out[name]:9.4f} ms", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1280)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--which", default="sepconv")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.which not in PORTED:
        ap.error(f"--which {args.which}: only the sepconv section is ported "
                 f"(the others time XLA ops only)")
    with torch.inference_mode():
        sepconv_bench(args.device, args.size, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
