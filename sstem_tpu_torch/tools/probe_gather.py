"""Probe: the gather and dynamic-shift roll primitives, and the serving
warp (counterpart of ``tools/probe_gather.py``).

    python -m sstem_tpu_torch.tools.probe_gather --parity [--size 256]
    python -m sstem_tpu_torch.tools.probe_gather --bench [--size 1280]
        [--batch 4] [--iters 6]      (add --device cpu to run on the CPU)

``--parity``: the serving warp kernel (``kernels.serving_warp``) against
``ops.spatial_transform`` on five flow cases at ``size``: fold flows
(``ops.fold_flows``), uniform flows of +-3 and +-40 pixels, coordinates far
outside the image, and integer flows. Exit code 1 if any differs by 1e-6.

``--bench``: ``take_along_axis`` on the JAX probe's eight (axis, rows, cols)
cases and the dynamic-shift roll on (8, 128) and (8, 1280) with shift 17,
in ms per call; then ``spatial_transform`` and the warp kernel on random
and on fold flows, in ms per section.
"""

import argparse
import sys

import numpy as np
import torch

from sstem_tpu_torch.kernels import roll_dynamic, serving_warp, take_along_axis
from sstem_tpu_torch.ops import fold_flows, spatial_transform
from sstem_tpu_torch.tools._timing import generator, seconds

GATHER_CASES = ((0, 256, 128), (0, 1288, 128), (0, 256, 1280), (1, 8, 128),
                (1, 8, 256), (1, 8, 384), (1, 8, 1280), (1, 256, 1280))
ROLL_CASES = ((8, 128), (8, 1280))
ROLL_SHIFT = 17


def flow_cases(n, h, w, device, seed=0):
    """The five parity flows, (n, h, w, 2) float32 each."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    return {"fold_flow2": t(fold_flows(n, h, w, seed)),
            "uniform_pm3": t(rng.uniform(-3, 3, (n, h, w, 2))),
            "uniform_pm40": t(rng.uniform(-40, 40, (n, h, w, 2))),
            "far_oob": t(rng.uniform(-2 * h, 2 * h, (n, h, w, 2))),
            "integer_flow": t(rng.integers(-5, 6, (n, h, w, 2)))}


def parity(device="cuda", size=256, n=2, seed=0):
    """Returns (ok, {case: max abs error})."""
    rng = np.random.default_rng(seed)
    im = torch.from_numpy(rng.random((n, size, size, 1), dtype=np.float32)).to(
        device)
    errs, ok = {}, True
    for name, flow in flow_cases(n, size, size, device, seed).items():
        err = float((serving_warp(im, flow) - spatial_transform(im, flow))
                    .abs().max())
        errs[name] = err
        ok &= err < 1e-6
        status = "OK " if err == 0.0 else ("ok~" if err < 1e-6 else "FAIL")
        print(f"{status} {name:14s} max_abs_err={err:.3e}", flush=True)
    return ok, errs


def gather_inputs(axis, rows, cols, device, gen):
    src = torch.rand((rows, cols), generator=gen, device=device)
    idx = torch.randint(0, rows if axis == 0 else cols, (rows, cols),
                        generator=gen, device=device, dtype=torch.int32)
    return src, idx


def bench(device="cuda", size=1280, batch=4, iters=6, seed=0):
    """Returns {name: ms} (per call for the primitives, per section for the
    warps)."""
    gen = generator(device, seed)
    out = {}

    def report(name, s, per=1):
        out[name] = s * 1e3 / per
        unit = "ms/section" if per > 1 else "ms"
        print(f"{name:36s} {out[name]:9.4f} {unit}", flush=True)

    for axis, rows, cols in GATHER_CASES:
        src, idx = gather_inputs(axis, rows, cols, device, gen)
        report(f"prim_gather axis={axis} {rows}x{cols}",
               seconds(lambda: take_along_axis(src, idx, axis), device, iters))
    for rows, cols in ROLL_CASES:
        src = torch.rand((rows, cols), generator=gen, device=device)
        shift = torch.tensor([ROLL_SHIFT], dtype=torch.int32, device=device)
        report(f"prim_roll_dynshift {rows}x{cols}",
               seconds(lambda: roll_dynamic(src, shift), device, iters))
    im = torch.rand((batch, size, size, 1), generator=gen, device=device)
    flow = torch.randn((batch, size, size, 2), generator=gen, device=device) * 3
    fold = torch.from_numpy(fold_flows(batch, size, size, seed)).to(device)
    report("spatial_transform (plain)",
           seconds(lambda: spatial_transform(im, flow), device, iters), batch)
    report("serving_warp kernel",
           seconds(lambda: serving_warp(im, flow), device, iters), batch)
    report("serving_warp kernel, fold flow",
           seconds(lambda: serving_warp(im, fold), device, iters), batch)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parity", action="store_true")
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=6)
    args = ap.parse_args(argv)
    with torch.inference_mode():
        if args.parity:
            ok, _ = parity(args.device, args.size or 256)
            return 0 if ok else 1
        if args.bench:
            bench(args.device, args.size or 1280, args.batch, args.iters)
            return 0
    print("pass --parity or --bench")
    return 2


if __name__ == "__main__":
    sys.exit(main())
