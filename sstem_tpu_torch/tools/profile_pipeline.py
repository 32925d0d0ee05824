"""Per-stage profile of the SFF pipeline's nets at full-section size
(counterpart of ``tools/profile_pipeline.py``).

    python -m sstem_tpu_torch.tools.profile_pipeline [--size 1280]
        [--iters 5] [--precision default|high|highest]
        [--compute-dtype bfloat16] [--device cuda|cpu]

Each stage runs as the port's module forward (eval, inference mode) on
seeded random weights at 1 x size^2, under the matmul precision and
compute dtype given (``config``; the caller's are set back after): the
sepconv (one channel, K=51, float32 image and maps), IFNet(51), FusionNet
(2 flow channels), UNetSFF and the serving warp kernel on a zero flow.
Times are CUDA events on the card (the host clock only with ``--device
cpu``), mean ms a call after 3 warm calls. Without a card and without
``--device cpu`` it prints one error line and exits 2.
"""

import argparse
import sys

import torch

from sstem_tpu_torch.tools._timing import (
    card_missing, generator, policy, seconds)

K = 51
# the JAX tool's row labels (tools/profile_pipeline.py:62-79)
ROWS = ("sepconv (1ch, K=51)", "IFNet fwd", "FusionNet fwd", "UNetSFF fwd",
        "warp (1ch)")


@torch.inference_mode()
def profile_pipeline(device="cuda", size=1280, iters=5, warm=3,
                     precision="default", compute_dtype=None, seed=0):
    """Returns {row: ms per call} for ``ROWS``, printing each row."""
    from sstem_tpu_torch.kernels import sepconv_planar, serving_warp
    from sstem_tpu_torch.models import FusionNet, IFNet, UNetSFF

    h = w = size
    gen = generator(device, seed)
    g = torch.Generator().manual_seed(seed)
    x6 = torch.randn((1, h, w, 6), generator=gen, device=device)
    x6c = x6.permute(0, 3, 1, 2).contiguous()
    im = torch.randn((1, 1, h + K - 1, w + K - 1), generator=gen,
                     device=device)
    v = torch.randn((1, K, h, w), generator=gen, device=device) / K
    hk = torch.randn((1, K, h, w), generator=gen, device=device) / K
    ifnet = IFNet(K, generator=g).to(device).eval()
    fusionnet = FusionNet(output_nc=2, generator=g).to(device).eval()
    unet = UNetSFF(generator=g).to(device).eval()
    flow = torch.zeros((1, h, w, 2), device=device)
    x1 = x6[..., 0:1].contiguous()
    stages = (lambda: sepconv_planar(im, v, hk), lambda: ifnet(x6c),
              lambda: fusionnet(x6c), lambda: unet(x6c),
              lambda: serving_warp(x1, flow))
    rows = {}
    with policy(precision, compute_dtype):
        for name, fn in zip(ROWS, stages):
            rows[name] = seconds(fn, device, iters, warm) * 1e3
            print("%-22s %.1f ms" % (name, rows[name]), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1280)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--precision", default="default",
                    choices=["default", "high", "highest"])
    ap.add_argument("--compute-dtype", default=None, choices=["bfloat16"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if card_missing("profile_pipeline", args.device):
        return 2
    profile_pipeline(args.device, args.size, args.iters,
                     precision=args.precision,
                     compute_dtype=args.compute_dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
