"""Probe: the copy bandwidth the card reaches, and the conv3x3 kernel
against the library conv (counterpart of
``tools/probe_dma_conv.py``).

    python -m sstem_tpu_torch.tools.probe_dma_conv [--copy] [--conv]
        [--device cuda|cpu] [--iters 8]

1. ``--copy``: device memory -> device memory in 4 KB tiles
   (``kernels.tile_copy``; ``ty=4``, the TPU probe's slab of leading rows,
   is printed and changes nothing), for bf16 (1280, 1280, C),
   C in {51, 64, 128}, and a planar (64, 1280, 1280): ms, GB/s with reads
   and writes counted, and whether the copy is exact.
2. ``--conv``: the conv3x3 kernel (``conv3x3_fused`` with no activation and
   an identity affine, the JAX probe's 9-shifted-dot conv, N=1, no bias,
   bf16 out) beside ``F.conv2d`` in bf16 on channels-last tensors, at
   (C -> Co, size) = (64 -> 64, 1280), (32 -> 32, 1280), (128 -> 128, 640):
   each one's ms and GB/s, and the largest difference between them.

With neither flag both run.
"""

import argparse
import sys

import torch
import torch.nn.functional as F

from sstem_tpu_torch.kernels import conv3x3_fused, fold_affine, tile_copy
from sstem_tpu_torch.tools._timing import generator, seconds

COPY_SHAPES = (("NHWC C=51  (1280,1280,51)", (1280, 1280, 51)),
               ("NHWC C=64  (1280,1280,64)", (1280, 1280, 64)),
               ("NHWC C=128 (1280,1280,128)", (1280, 1280, 128)),
               ("planar     (64,1280,1280)", (64, 1280, 1280)))
COPY_TY = 4
# the copy's edges (name, shape, dtype, ty): byte counts that are not a
# multiple of 16, arrays smaller than one 16 KB stage or than 16 bytes,
# chunks whose last piece is partial, and ty above the row count
COPY_EDGE_CASES = (
    ("int8, odd width", (37, 1001), "int8", 4),
    ("bf16, odd width", (5, 1001), "bfloat16", 4),
    ("smaller than one stage", (100,), "bfloat16", 4),
    ("under 16 bytes", (7,), "uint8", 1),
    ("partial last pieces", (1000, 12345), "uint8", 4),
    ("ty above the row count", (3, 17, 5), "bfloat16", 8),
)
CONV_CASES = ((64, 64, 1280), (32, 32, 1280), (128, 128, 640))


def copy_probe(device="cuda", shapes=COPY_SHAPES, ty=COPY_TY, iters=8,
               seed=0):
    """Returns [{name, shape, ms, gb_per_s, correct}] (GB/s counts the
    bytes read and written)."""
    gen = generator(device, seed)
    out = []
    for name, shape in shapes:
        x = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
        ok = bool(torch.equal(tile_copy(x, ty), x))
        s = seconds(lambda: tile_copy(x, ty), device, iters)
        gb = 2 * x.numel() * x.element_size() / 1e9
        out.append({"name": name, "shape": shape, "ms": s * 1e3,
                    "gb_per_s": gb / s, "correct": ok})
        print(f"{name:30s} {s * 1e3:8.4f} ms  {gb / s:7.1f} GB/s  "
              f"correct={ok}", flush=True)
        del x
    return out


def conv_probe(device="cuda", cases=CONV_CASES, iters=8, seed=0):
    """Returns [{c, co, hw, ms, library_ms, max_err}] for the conv kernel
    and F.conv2d on the same bf16 (1, hw, hw, c) input and weights."""
    gen = generator(device, seed)
    out = []
    for c, co, hw in cases:
        x = torch.randn((1, hw, hw, c), generator=gen, device=device).to(
            torch.bfloat16)
        w = (torch.randn((3, 3, c, co), generator=gen, device=device)
             / (3 * c)).to(torch.bfloat16)
        scale, shift = fold_affine(co)
        scale, shift = scale.to(device), shift.to(device)
        w_cl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

        def kernel():
            return conv3x3_fused(x, w, scale, shift, None)

        def library():
            return F.conv2d(x.permute(0, 3, 1, 2), w_cl, padding=1)

        err = float((kernel().float() - library().permute(0, 2, 3, 1).float())
                    .abs().max())
        s_k = seconds(kernel, device, iters)
        s_l = seconds(library, device, iters)
        gb = 2 * (x.numel() + hw * hw * co) / 1e9
        out.append({"c": c, "co": co, "hw": hw, "ms": s_k * 1e3,
                    "library_ms": s_l * 1e3, "max_err": err})
        print(f"C{c}->{co} @{hw}: kernel {s_k * 1e3:7.4f} ms "
              f"({gb / s_k:6.1f} GB/s)  library {s_l * 1e3:7.4f} ms "
              f"({gb / s_l:6.1f} GB/s)  maxerr {err:.3e}", flush=True)
        del x, w, w_cl
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--copy", action="store_true")
    ap.add_argument("--conv", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args(argv)
    both = not (args.copy or args.conv)
    ok = True
    with torch.inference_mode():
        if args.copy or both:
            print(f"== tile copy, ty={COPY_TY} (read+write counted) ==",
                  flush=True)
            ok = all(r["correct"] for r in copy_probe(args.device,
                                                      iters=args.iters))
        if args.conv or both:
            print("== conv3x3: kernel vs F.conv2d (bf16, channels-last) ==",
                  flush=True)
            conv_probe(args.device, iters=args.iters)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
