"""Per-piece profile of the packed serving path (counterpart of
``tools/profile_serve.py``).

    python -m sstem_tpu_torch.tools.profile_serve [--size 1280] [--batch 4]
        [--iters 6] [--device cuda|cpu]

Times the pieces that ``SFFPipeline(packed_conv=True)`` composes, in bf16
on seeded random weights at batch x size^2: ``ifnet_serve`` whole; its
trunk to the heads' features and one kernel head, with its convs 0-2 and
its cuDNN tail's 2x upsample and conv3 apart, composed from
``models/serving.py``'s own helpers; the sepconv kernel on bf16 maps;
``fusionnet_serve`` and ``unet_sff_serve`` on 2-channel gray pairs; and
the plain warp (``ops.spatial_transform``, the JAX tool's XLA warp) beside
the serving warp kernel. Two rows are the port's own, for its other head
tails: one head's tail on the ``head_tail`` kernel, and the four heads'
tails batched into one upsample and one grouped conv3
(``ifnet_serve(batched_head_tail=True)``). The serving forwards read no
numerical policy, so none is set.

Each row is ms per section (per image of the batch): CUDA events on the
card (the host clock only with ``--device cpu``), mean of ``--iters``
calls after 10 warm ones (the JAX tool's best of three rounds is one round
here). Without a card and without ``--device cpu`` it prints one error
line and exits 2.
"""

import argparse
import sys

import torch
import torch.nn.functional as F

from sstem_tpu_torch.tools._timing import card_missing, generator, seconds

K = 51
HEAD = "upconv51_1"  # the JAX tool's head2h: the k2h head
# the JAX tool's row labels (tools/profile_serve.py:67-199), then the
# port's two tail rows
ROWS = ("ifnet_serve (full)", "  trunk (to featq)", "  1 head (full tail)",
        "    head conv0-2", "    planar upsample 2x",
        "    planar conv3 51->51", "  sepconv planar 1ch",
        "fusionnet_serve (2ch)", "unet_sff_serve (2ch)", "warp XLA (1ch)",
        "warp banded serving (1ch)")
PORT_ROWS = ("    head tail kernel (fused tail)",
             "  4 head tails batched (grouped conv3)")


@torch.inference_mode()
def profile_serve(device="cuda", size=1280, batch=4, iters=6, warm=10,
                  seed=0):
    """Returns {row: ms per section} for ``ROWS`` and ``PORT_ROWS``,
    printing each row."""
    from sstem_tpu_torch.kernels import head_tail, sepconv_planar, serving_warp
    from sstem_tpu_torch.models import FusionNet, IFNet, UNetSFF
    from sstem_tpu_torch.models import serving as sv
    from sstem_tpu_torch.models.ifnet import HEADS
    from sstem_tpu_torch.ops import spatial_transform

    n, h, w = batch, size, size
    bf16 = torch.bfloat16
    gen = generator(device, seed)
    g = torch.Generator().manual_seed(seed)

    def rand(shape, dtype=torch.float32):
        return torch.rand(shape, generator=gen, device=device).to(dtype)

    model = IFNet(K, generator=g).to(device).eval()
    fusionnet = FusionNet(output_nc=2, generator=g).to(device).eval()
    unet = UNetSFF(generator=g).to(device).eval()
    x6 = rand((n, h, w, 6))
    x2 = x6[..., 0:2].contiguous()
    p = sv._ifnet_prepared(model, False, "cudnn")
    pf = sv._ifnet_prepared(model, False, "fused")
    pb = sv._ifnet_prepared(model, False, "batched")
    featq = sv._ifnet_trunk(p, x6)
    half64 = sv._head_half(pf, HEAD, featq)
    halves = torch.cat([sv._head_half(pb, name, featq)
                        for name in HEADS[1][0]], -1)
    hmap_half = rand((n, K, h // 2, w // 2), bf16)
    hmap_full = rand((n, K, h, w), bf16)
    w3 = rand((K, K, 3, 3), bf16)
    imp = rand((n, 1, h + K - 1, w + K - 1), bf16)
    vm, hm = rand((n, K, h, w), bf16) / K, rand((n, K, h, w), bf16) / K
    im1 = x6[..., 0:1].contiguous()
    flow = torch.randn((n, h, w, 2), generator=gen, device=device) * 3

    pieces = (
        lambda: sv.ifnet_serve(model, x6),
        lambda: sv._ifnet_trunk(p, x6),
        lambda: sv._planar_tail(sv._head_half(p, HEAD, featq), *p[HEAD][1]),
        lambda: sv._head_half(p, HEAD, featq),
        lambda: F.interpolate(hmap_half, scale_factor=2, mode="bilinear",
                              align_corners=True),
        lambda: F.conv2d(hmap_full, w3, padding=1),
        lambda: sepconv_planar(imp, vm, hm),
        lambda: sv.fusionnet_serve(fusionnet, x2),
        lambda: sv.unet_sff_serve(unet, x2),
        lambda: spatial_transform(im1, flow),
        lambda: serving_warp(im1, flow),
        lambda: head_tail(half64, *pf[HEAD][1]),
        lambda: sv._planar_tail(halves, *pb["batched"], groups=4),
    )
    rows = {}
    for name, fn in zip(ROWS + PORT_ROWS, pieces):
        rows[name] = seconds(fn, device, iters, warm) * 1e3 / n
        print("%-38s %7.2f ms/section" % (name, rows[name]), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1280)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if card_missing("profile_serve", args.device):
        return 2
    profile_serve(args.device, args.size, args.batch, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
