"""Compare the float32 and bf16 paths of the full SFF pipeline (counterpart
of ``tools/quality_check.py``).

    python -m sstem_tpu_torch.tools.quality_check --interp CKPT --flow CKPT
        --fusion CKPT [--size 512] [--device cuda|cpu] [--packed-conv]

Restores section 1 of ``synth_stack(3, size, size, seed=0)`` with
``SFFPipeline`` in float32 and in ``SERVING_DTYPE`` (on the card with
``--packed-conv``, the fused-conv serving path), both under
``set_matmul_precision("default")`` as the JAX tool runs them, and reports
the largest gray-level difference and the PSNR between the two paths per
output. A checkpoint left out is replaced by weights from seed 0; with
random weights the delta is meaningless (untrained KPN taps amplify
rounding): run with trained checkpoints before serving in bf16 (budget:
<= 0.1 dB on the restoration metrics).
"""

import argparse

import numpy as np

KERNEL_SIZE = 51  # the interp KPN's K, as the JAX tool builds it
OUTPUTS = ("interp", "fused", "stitch")


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--interp", default=None)
    ap.add_argument("--flow", default=None)
    ap.add_argument("--fusion", default=None)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--packed-conv", action="store_true",
                    help="the bf16 path on the fused-conv serving forwards "
                         "(card only)")
    return ap


def build_models(args, seed=0):
    """IFNet(KERNEL_SIZE), FusionNet and UNetSFF from the checkpoints
    given, each other one from ``seed``."""
    import torch

    from sstem_tpu_torch.cli._ckpt import load_model
    from sstem_tpu_torch.models import FusionNet, IFNet, UNetSFF

    g = torch.Generator().manual_seed(seed)
    builds = ((args.interp, lambda: IFNet(KERNEL_SIZE, generator=g)),
              (args.flow, lambda: FusionNet(output_nc=2, generator=g)),
              (args.fusion, lambda: UNetSFF(out_channel=1, generator=g)))
    return [load_model(build, path) if path else build()
            for path, build in builds]


def compare(outs):
    """{output: (max |difference| in gray levels, PSNR of one path against
    the other in dB)} of the two paths' section-1 results."""
    rows = {}
    for key in OUTPUTS:
        a = outs["float32"][1][key].astype(np.float64)
        b = outs["bfloat16"][1][key].astype(np.float64)
        mse = np.mean((a - b) ** 2)
        psnr = 99.0 if mse < 1e-9 else 20 * np.log10(255 / np.sqrt(mse))
        rows[key] = (float(np.abs(a - b).max()), float(psnr))
    return rows


def main(argv=None):
    """Returns ``compare``'s rows; the caller's precision policy is set back
    after the run."""
    from sstem_tpu_torch import config
    from sstem_tpu_torch.data.synthetic import synth_stack
    from sstem_tpu_torch.infer.pipeline import SFFPipeline

    args = parser().parse_args(argv)
    if args.packed_conv and args.device != "cuda":
        raise SystemExit("--packed-conv runs on the card only")
    if not args.interp:
        print("WARNING: random interp weights — deltas are not meaningful")
    prior = config.matmul_precision()
    config.set_matmul_precision("default")
    try:
        stack = synth_stack(3, args.size, args.size, seed=0)
        outs = {}
        for mode, dtype in (("float32", config.PARITY_DTYPE),
                            ("bfloat16", config.SERVING_DTYPE)):
            pipe = SFFPipeline(*build_models(args), device=args.device,
                               dtype=dtype,
                               packed_conv=(mode == "bfloat16"
                                            and args.packed_conv))
            outs[mode] = pipe.restore_stack(stack, [1], chunk=1)
    finally:
        config.set_matmul_precision(prior)
    rows = compare(outs)
    for key, (diff, psnr) in rows.items():
        print("%s: max|d|=%.1f gray, PSNR(f32 vs bf16)=%.1f dB"
              % (key, diff, psnr))
    return rows


if __name__ == "__main__":
    main()
