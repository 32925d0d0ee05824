"""Fine-grained stage profile of the restore's nets at the bench's batch
(counterpart of ``tools/profile_fine.py``).

    python -m sstem_tpu_torch.tools.profile_fine [--size 1280] [--batch 4]
        [--iters 6] [--f32] [--device cuda|cpu]

The JAX tool times its ``packed=True`` IFNet twin, a TPU layout the port
does not have; this one times the port's module path, the cuDNN restore
path, under ``config.set_matmul_precision("default")`` and
``set_compute_dtype("bfloat16")`` (``--f32``: float32 activations), the
caller's policy set back after. On seeded random weights at batch x
size^2: IFNet(51) whole, its trunk to the x64 features
(``ifnet_prefix_bench.ifnet_prefix``), one kernel head on trunk-shaped
features, the sepconv kernel, FusionNet, UNetSFF and the serving warp
kernel. The rows keep the JAX tool's labels, "packed" among them.

Each row is ms per section (per image of the batch): CUDA events on the
card (the host clock only with ``--device cpu``), mean of ``--iters``
calls after 8 warm ones. Without a card and without ``--device cpu`` it
prints one error line and exits 2.
"""

import argparse
import sys

import torch

from sstem_tpu_torch.tools._timing import (
    card_missing, generator, policy, seconds)

K = 51
# the JAX tool's row labels (tools/profile_fine.py:67-144)
ROWS = ("IFNet packed (full)", "IFNet trunk (to x64)",
        "1 kernel head (packed)", "sepconv planar (1ch)", "FusionNet (flow)",
        "UNetSFF (fusion)", "warp (1ch)")


@torch.inference_mode()
def profile_fine(device="cuda", size=1280, batch=4, iters=6, warm=8,
                 f32=False, seed=0):
    """Returns {row: ms per section} for ``ROWS``, printing each row."""
    from sstem_tpu_torch.kernels import sepconv_planar, serving_warp
    from sstem_tpu_torch.models import FusionNet, IFNet, UNetSFF
    from sstem_tpu_torch.tools.ifnet_prefix_bench import ifnet_prefix

    n, h, w = batch, size, size
    dtype = torch.float32 if f32 else torch.bfloat16
    gen = generator(device, seed)
    g = torch.Generator().manual_seed(seed)

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    ifnet = IFNet(K, generator=g).to(device).eval()
    fusionnet = FusionNet(output_nc=2, generator=g).to(device).eval()
    unet = UNetSFF(generator=g).to(device).eval()
    x6 = randn((n, h, w, 6))
    x6c = x6.permute(0, 3, 1, 2).contiguous()
    feat = randn((n, 64, h // 2, w // 2), dtype)
    imp = randn((n, 1, h + K - 1, w + K - 1), dtype)
    vm, hm = randn((n, K, h, w), dtype) / K, randn((n, K, h, w), dtype) / K
    im1 = x6[..., 0:1].contiguous()
    flow = randn((n, h, w, 2)) * 3
    stages = (lambda: ifnet(x6c), lambda: ifnet_prefix(ifnet, x6c, "dec"),
              lambda: ifnet.upconv51_1(feat),
              lambda: sepconv_planar(imp, vm, hm), lambda: fusionnet(x6c),
              lambda: unet(x6c), lambda: serving_warp(im1, flow))
    rows = {}
    with policy("default", None if f32 else "bfloat16"):
        for name, fn in zip(ROWS, stages):
            rows[name] = seconds(fn, device, iters, warm) * 1e3 / n
            print("%-26s %7.1f ms/section" % (name, rows[name]), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1280)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if card_missing("profile_fine", args.device):
        return 2
    profile_fine(args.device, args.size, args.batch, args.iters,
                 f32=args.f32)
    return 0


if __name__ == "__main__":
    sys.exit(main())
