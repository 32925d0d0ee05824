"""Micro-benchmark of the library conv, deconv, pool and BatchNorm pieces of
the full-section nets (counterpart of ``tools/micro_conv_bench.py``).

    python -m sstem_tpu_torch.tools.micro_conv_bench [--device cuda|cpu]

Each of the JAX tool's rows as one cuDNN (or elementwise) call in bf16 at
batch 4, the tool's shapes: the 3x3 convs of FusionNet's levels, the 2x
deconv as a transposed conv (the JAX row's dilated conv) and as a 4-phase
conv to 4 x Cout channels with a pixel shuffle, the IFNet head's 51->51
conv3 (channels-last, planar NCHW, padded to 64, four heads as a grouped
conv, four heads as a batch x 4), the first 6->32 conv, a 2x2 max pool
and an unfused eval-BatchNorm affine. Tensors are channels-last where the
JAX rows are NHWC, contiguous NCHW where they are planar.

Each row is ms per section (the batch's time over 4, as the JAX tool
divides): CUDA events on the card (the host clock only with ``--device
cpu``), mean of 6 calls after 10 warm ones. Without a card and without
``--device cpu`` it prints one error line and exits 2.
"""

import argparse
import sys

import torch
import torch.nn.functional as F

from sstem_tpu_torch.tools._timing import card_missing, generator, seconds

# the JAX tool's row labels (tools/micro_conv_bench.py:50-130)
ROWS = ("conv3x3 32->32 @1280 bf16", "conv3x3 64->64 @640 bf16",
        "conv3x3 128->128 @320 bf16", "conv3x3 256->256 @160 bf16",
        "conv3x3 512->512 @80 bf16", "deconv(dilated) 64->32 @640->1280",
        "deconv(d2s 3x3-4phase) 64->32 @640->1280",
        "conv3x3 51->51 @1280 bf16 (head conv3)",
        "conv3x3 51->51 @1280 NCHW planar",
        "conv3x3 64->64 @1280 NHWC (padded)",
        "conv3x3 grouped4 204->204 @1280 NHWC",
        "conv3x3 grouped4 256->256 @1280 NHWC",
        "conv3x3 51->51 @1280 NCHW batchx4 (/4)",
        "conv3x3 64->64 @1280 NCHW planar (padded)", "conv3x3 6->32 @1280",
        "maxpool2x2 @1280x32", "BN-eval elementwise @1280x32 (unfused)")


@torch.inference_mode()
def micro_conv_bench(device="cuda", size=1280, batch=4, iters=6, warm=10,
                     seed=0):
    """Returns {row: ms per section} for ``ROWS``, printing each row.
    ``size`` stands for the rows' 1280 (the other sizes scale with it);
    the rows keep the JAX tool's labels."""
    n = batch
    gen = generator(device, seed)
    cl = torch.channels_last

    def mk(c, hw, nb=n, layout=cl):
        """(nb, c, hw, hw) bf16 in ``layout``."""
        return torch.randn((nb, c, hw, hw), generator=gen, device=device).to(
            torch.bfloat16).contiguous(memory_format=layout)

    def wt(cout, cin, layout=cl):
        return mk(cin, 3, cout, layout)

    def conv(x, w, groups=1):
        return F.conv2d(x, w, padding=1, groups=groups)

    s = size
    nchw = torch.contiguous_format

    def affine():
        x = mk(32, s)
        return (x, *torch.randn((2, 1, 32, 1, 1), generator=gen,
                                device=device))

    # (call, its arguments, made when the row runs)
    cases = (
        (conv, lambda: (mk(32, s), wt(32, 32))),
        (conv, lambda: (mk(64, s // 2), wt(64, 64))),
        (conv, lambda: (mk(128, s // 4), wt(128, 128))),
        (conv, lambda: (mk(256, s // 8), wt(256, 256))),
        (conv, lambda: (mk(512, s // 16), wt(512, 512))),
        # the transposed conv's weight is (Cin, Cout, 3, 3)
        (lambda a, b: F.conv_transpose2d(a, b, stride=2, padding=1,
                                         output_padding=1),
         lambda: (mk(64, s // 2), wt(64, 32))),
        (lambda a, b: F.pixel_shuffle(conv(a, b), 2),
         lambda: (mk(64, s // 2), wt(128, 64))),
        (conv, lambda: (mk(51, s), wt(51, 51))),
        (conv, lambda: (mk(51, s, layout=nchw), wt(51, 51, nchw))),
        (conv, lambda: (mk(64, s), wt(64, 64))),
        (lambda a, b: conv(a, b, 4), lambda: (mk(204, s), wt(204, 51))),
        (lambda a, b: conv(a, b, 4), lambda: (mk(256, s), wt(256, 64))),
        (conv, lambda: (mk(51, s, 4 * n, nchw), wt(51, 51, nchw))),
        (conv, lambda: (mk(64, s, layout=nchw), wt(64, 64, nchw))),
        (conv, lambda: (mk(6, s), wt(32, 6))),
        (lambda a: F.max_pool2d(a, 2), lambda: (mk(32, s),)),
        (lambda a, b, c: (a.float() * b + c).to(torch.bfloat16), affine),
    )
    rows = {}
    for name, (fn, make) in zip(ROWS, cases):
        args = make()
        rows[name] = seconds(lambda: fn(*args), device, iters, warm) * 1e3 / n
        print("%-42s %7.2f ms/section" % (name, rows[name]), flush=True)
        del args
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if card_missing("micro_conv_bench", args.device):
        return 2
    micro_conv_bench(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
