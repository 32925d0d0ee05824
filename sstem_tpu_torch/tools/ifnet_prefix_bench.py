"""IFNet's forward time by stage, from its prefixes (counterpart of
``tools/ifnet_prefix_bench.py``).

    python -m sstem_tpu_torch.tools.ifnet_prefix_bench [--device cuda|cpu]

Times IFNet(51)'s module forward (eval, inference mode, seeded random
weights, float32 weights under the ``default`` matmul precision, the JAX
tool's setting) at 1 x 1280^2, cut after each of the JAX tool's points:
``L0`` (conv32), ``enc`` (through conv512x512), ``dec`` (through upsamp64
and the x64 skip), ``heads`` (the four kernel heads, summed) and ``full``
(with the two sepconvs). Successive differences attribute time to the
stages. ms a call, CUDA events on the card (the host clock only with
``--device cpu``), mean of 8 calls after 2 warm ones. Without a card and
without ``--device cpu`` it prints one error line and exits 2.
"""

import argparse
import sys

import torch
import torch.nn.functional as F

from sstem_tpu_torch.models.ifnet import HEADS
from sstem_tpu_torch.tools._timing import (
    card_missing, generator, policy, seconds)

K = 51
# the JAX tool's cut points (tools/ifnet_prefix_bench.py:102)
STAGES = ("L0", "enc", "dec", "heads", "full")


def ifnet_prefix(model, x, upto):
    """``IFNet.forward`` on (N, 6, H, W) cut after stage ``upto`` of
    ``STAGES``: the stage's output (``heads``: the sum of every head's tap
    maps)."""
    if upto == "full":
        return model(x)
    x = model.conv32(x)
    if upto == "L0":
        return x
    x64 = model.conv64(F.avg_pool2d(x, 2))
    x128 = model.conv128(F.avg_pool2d(x64, 2))
    x256 = model.conv256(F.avg_pool2d(x128, 2))
    x512 = model.conv512(F.avg_pool2d(x256, 2))
    x = model.conv512x512(F.avg_pool2d(x512, 2))
    if upto == "enc":
        return x
    x = model.upconv256(model.upsamp512(x) + x512)
    x = model.upconv128(model.upsamp256(x) + x256)
    x = model.upconv64(model.upsamp128(x) + x128)
    x = model.upsamp64(x) + x64
    if upto == "dec":
        return x
    return sum(getattr(model, name)(x).float().sum()
               for frame in HEADS[model.n_frames] for name in frame)


@torch.inference_mode()
def ifnet_prefix_bench(device="cuda", size=1280, iters=8, warm=2, seed=0):
    """Returns {stage: ms per call} for ``STAGES``, printing each."""
    from sstem_tpu_torch.models import IFNet

    x6 = torch.randn((1, 6, size, size), generator=generator(device, seed),
                     device=device)
    model = IFNet(K, generator=torch.Generator().manual_seed(seed))
    model = model.to(device).eval()
    rows = {}
    with policy("default"):
        for stage in STAGES:
            rows[stage] = seconds(lambda: ifnet_prefix(model, x6, stage),
                                  device, iters, warm) * 1e3
            print("%-10s %8.2f ms" % (stage, rows[stage]), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if card_missing("ifnet_prefix_bench", args.device):
        return 2
    ifnet_prefix_bench(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
