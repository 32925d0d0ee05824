#!/usr/bin/env python3
"""Smoke run of the sstem_tpu_torch port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device: a CUDA card is required; prints nvidia-smi's name and power limit
  2. build: compiles sstem_tpu_torch/csrc/*.cu with nvcc (prints ptxas output,
     the build seconds, registers and spills of the Hopper designs, and any
     wgmma serialization warning)
  3. the sepconv forward's two designs (the one the shape picks, and the
     simple one) vs its plain PyTorch version at every SEPCONV_CHECKS row
  4. warp kernel vs its plain PyTorch version on the same inputs
  5. pipeline on the card vs on the CPU (K=51, float32, TF32 off)
  6. full size: restore_stack_scanned on a 25 x 1250^2 stack, 12 damaged
     sections, chunk 4, K=51, ngf=32, in bfloat16 and in float32, with the
     kernels' launch counts and signatures, ms/section and peak memory
  7. the sepconv forward at the SFF shapes (both designs) and the warp
     kernel, beside their plain versions and bounds (CUDA events)
  8. the sepconv backward's two designs (the one the shape picks, and the
     simple one) vs its plain PyTorch version at every SEPCONV_BWD_CHECKS
     row but the training signature (phase 11 holds that one)
  9. one IFNet training step on the card vs on the CPU (K=51, 64^2, float32,
     TF32 off): loss and every parameter's gradient
 10. full width training: ``train_interp.main`` for a few steps on the interp
     trainer's workload (IFNet K=51, 256^2 crops, batch 32, L1, AdamW wd 1e-4
     under the poly warmup/decay LR, float32 with TF32 off, a synthetic
     triplet tree of 16 x 320^2 made from the seed), then the step of
     ``build(cfg)`` timed: ms/step, steps/s, MP/s, peak memory, and the
     sepconv launches and signatures (forward and backward, each checked
     against its list) per step, and 2 steps under
     torch.profiler (device busy time, idle share, device time by kind)
 11. the sepconv forward and backward kernels (both designs each) vs their
     plain versions at the training shape, and their times (CUDA events)
 12. conv3x3, pool, deconv and head-tail kernels vs their plain versions at
     every conv3x3 and deconv signature the packed_conv=True SFF path
     launches at full width (SFF_CONV_CHECKS, DECONV_CHECKS) and at odd
     sizes for the edges; the head tail's two designs at every
     HEAD_TAIL_CHECKS row
 13. the packed_conv=True pipeline on the card vs on the CPU (K=51, bfloat16
     on both sides): NRMSE of each float output, uint8 level differences
 14. phase 6's workload in bfloat16 on the packed_conv=True path, with the
     head tails on cuDNN and on the head-tail kernel, beside the cuDNN path:
     launch counts per group asserted, signatures checked, ms/section, peak
     memory, and one call under torch.profiler each
 15. every conv3x3 and deconv shape of the SFF packed path at full width
     (CUDA events): the design the kernel picks, the mma.sync design in the
     same call, the plain version, the bound, the bare cuDNN call and (conv)
     cuDNN with the epilogue as separate ops, and the launches per group;
     then the pool, and the head tail (both designs) beside theirs
 16. the probe kernels (tile copy, gather, dynamic roll; exact, the gather
     and roll also at the edge cases of tools/probe_gather.py: EDGE_CASES)
     and conv3x3 at every SP path signature (SP_CONV_CHECKS) vs their plain
     versions
 17. SPPipeline.restore on the card vs on the CPU (K=51, two quartets of
     150 x 170): float32 with TF32 off, and the packed_conv=True path in
     bfloat16 on both sides
 18. full width SP: bench_sp.py's workload (6 quartets of 1250^2, batch 2,
     K=51, bfloat16) on the cuDNN and the packed path: launch counts per
     batch asserted, signatures checked, ms/quartet, MP/s, peak memory, one
     run under torch.profiler each; then every conv3x3 shape of the SP
     packed path timed as in phase 15, the SP pool, and the SP sepconv
     with both designs
 19. the probes through their entry points (probe_dma_conv, probe_gather
     --parity and --bench, micro_bench) with launch counts asserted and
     micro_bench's sepconv signature checked, then each probe kernel at the
     JAX probes' shapes beside its plain version, its library call and its
     bound (CUDA events; the sepconv with both designs); the gather and
     roll, and torch.gather / torch.roll beside them, timed in alternating
     rounds and split into host and device microseconds per call

Every number is printed on its own line beside the card's name and power
limit. The line before the last is the kernels' JSON summary; the last line
is {"ok": true, "device": {...}}. Weights are random, made from seeds; this
script imports nothing of JAX. What it writes goes under ``build/chip_smoke/``
in the checkout.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
K = 51
DEV = "cuda"  # where the checks make their inputs
GPU = None  # "name, power limit" from nvidia-smi
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                   "chip_smoke")
# the card's published peaks (H100 SXM at 700 W): HBM bytes/s, and float32
# FLOP/s outside the tensor cores (the kernels' FMAs are plain float32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# the interp trainer's workload
TRAIN_BATCH, TRAIN_PATCH = 32, 256


def say(key, value):
    print(f"{key} = {value}  [{GPU}]", flush=True)


def phase(name):
    print(f"--- {name}", flush=True)


def bf16_ulp(x):
    """One bf16 unit in the last place of |x| (8 significant bits)."""
    m = x.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


def rand(shape, gen, scale=1.0, dtype=torch.float32):
    return (torch.rand(shape, generator=gen, device=DEV) * scale).to(dtype)


def sepconv_inputs(n, c, h, w, k, image, maps, gen):
    """A unit-range padded image and maps whose taps sum to about 1 per
    pixel, in the dtypes named (SEPCONV_CHECKS)."""
    return (rand((n, c, h + k - 1, w + k - 1), gen, dtype=getattr(torch, image)),
            rand((n, k, h, w), gen, 2.0 / k, getattr(torch, maps)),
            rand((n, k, h, w), gen, 2.0 / k, getattr(torch, maps)))


def check_sepconv(n, c, h, w, k, image, maps, gen):
    """Both forward designs (the entry point that picks by shape, and the
    simple design's) against the plain version on the same inputs. Returns
    the max abs error of the design the shape picks."""
    from sstem_tpu_torch.kernels import sepconv as sc

    args = sepconv_inputs(n, c, h, w, k, image, maps, gen)
    want = sc.sepconv_planar_plain(*args)
    err = {}
    for name, entry in sc.ENTRY_POINTS.items():
        label = (f"sepconv {entry} (shape picks {sc.design(w)}) {n}x{c}x{h}x{w} "
                 f"K={k} image={image} maps={maps}")
        err[name] = assert_sepconv_close(label, sc.launch_entry(entry, *args),
                                         want, (n, c, h, w))
    return err[sc.design(w)]


def time_sepconv(n, c, h, w, k, image, maps, gen, reps=10):
    """The sepconv forward at one signature, by CUDA events: the design the
    entry point picks (ms, design), the simple design in the same call
    (simple_ms), the plain version and the bound. No single PyTorch call
    computes it (library_ms None)."""
    from sstem_tpu_torch.kernels import sepconv as sc

    args = sepconv_inputs(n, c, h, w, k, image, maps, gen)
    size = {"float32": 4, "bfloat16": 2}
    t = timing(cuda_ms(lambda: sc.launch_entry("sstem_sepconv_fwd", *args), reps, 2),
               cuda_ms(lambda: sc.sepconv_planar_plain(*args), 2), None,
               sepconv_bound(n, c, h, w, k, size[image], size[maps], False))
    t.update(design=sc.design(w), simple_ms=cuda_ms(
        lambda: sc.launch_entry(sc.ENTRY_POINTS["simple"], *args), reps, 2))
    return t


def assert_sepconv_close(label, got, want, shape):
    """The forward kernel's output against the plain version's: 1e-5 abs in
    float32, one bf16 ulp of the value in bfloat16. Returns the max abs error."""
    torch.cuda.synchronize()
    image_dtype = want.dtype
    assert got.dtype == image_dtype and got.shape == shape
    err = (got.float() - want.float()).abs()
    if image_dtype == torch.float32:
        tol = 1e-5
        ok = bool(err.max() <= tol)
    else:  # one bf16 ulp of the value: both round once from an f32 sum
        tol = "1 bf16 ulp"
        ok = bool((err <= bf16_ulp(torch.maximum(got.float().abs(),
                                                  want.float().abs()))).all())
    say(f"{label} max_abs_err", float(err.max()))
    assert ok, f"{label}: kernel disagrees with the plain version (tol {tol})"
    return float(err.max())


def check_warp(im, flow, label):
    from sstem_tpu_torch.kernels import serving_warp
    from sstem_tpu_torch.ops.warp import spatial_transform

    got = serving_warp(im, flow)
    want = spatial_transform(im, flow)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    say(f"warp {label} {tuple(im.shape)} max_abs_err", err)
    assert err <= 1e-6, f"warp {label}: kernel disagrees with the plain version"
    return err


def build_pipeline(device, dtype, seed=SEED, kernel_size=K, **options):
    """SFFPipeline on seeded random weights. The kernel heads' last conv is
    rescaled so each frame's taps sum to about 1/sqrt(2), as a trained KPN's
    do; otherwise the interp saturates at the clip and hides the sepconv.
    ``options`` go to SFFPipeline (packed_conv, fused_head_tail)."""
    from sstem_tpu_torch.infer.pipeline import SFFPipeline
    from sstem_tpu_torch.models import FusionNet, IFNet, UNetSFF

    g = torch.Generator().manual_seed(seed)
    interp = IFNet(kernel_size, generator=g)
    with torch.no_grad():
        for head in (interp.upconv51_1, interp.upconv51_2, interp.upconv51_3,
                     interp.upconv51_4):
            head[7].weight.mul_(0.002)
            head[7].bias.mul_(0.2).add_(1.0 / (kernel_size * 2 ** 0.5))
    return SFFPipeline(interp, FusionNet(ngf=32, generator=g),
                       UNetSFF(generator=g), device=device, dtype=dtype,
                       **options)


def compare_pipelines(gpu, cpu, ids):
    for i in ids:
        for key in ("interp", "fused", "warped"):
            d = int(np.abs(gpu[i][key].astype(np.int32)
                           - cpu[i][key].astype(np.int32)).max())
            say(f"pipeline card-vs-cpu section {i} {key} max_level_diff", d)
            assert d <= 1, (i, key, d)
        agree = (gpu[i]["warped"] >= 2) == (cpu[i]["warped"] >= 2)
        disagree = float(1 - agree.mean())
        d = int(np.abs(gpu[i]["stitch"].astype(np.int32)
                       - cpu[i]["stitch"].astype(np.int32))[agree].max())
        flow_err = float(np.abs(gpu[i]["flow"] - cpu[i]["flow"]).max())
        say(f"pipeline card-vs-cpu section {i} stitch_mask_disagree_frac", disagree)
        say(f"pipeline card-vs-cpu section {i} stitch max_level_diff", d)
        say(f"pipeline card-vs-cpu section {i} flow max_abs_err", flow_err)
        assert disagree <= 1e-3 and d <= 1 and flow_err <= 1e-3, i


# launches per group of the restore paths, by kernel (sepconv and warp on
# every path; the packed path's counts follow models/serving.py: conv3x3 19
# in IFNet, 21 in FusionNet, 10 in UNetSFF; one pool and two deconvs in
# FusionNet and UNetSFF, one pool in IFNet; a head tail per kernel head)
PATH_LAUNCHES = {
    "cudnn": {"sepconv_fwd": 2, "warp_bilinear": 1},
    "packed": {"sepconv_fwd": 2, "warp_bilinear": 1, "conv3x3_fused": 50,
               "pool2x": 3, "deconv2x_fused": 4},
    "packed_fused_tail": {"sepconv_fwd": 2, "warp_bilinear": 1,
                          "conv3x3_fused": 50, "pool2x": 3,
                          "deconv2x_fused": 4, "head_tail": 4},
}


# The conv3x3_fused and deconv2x_fused signatures (n, h, w, cin, cout, act,
# residual) that the packed paths launch at full width: the SFF restore on
# its 1280^2 canvas, 4 sections a group; the SP restore at 1280^2, batch 2.
# Phases 12 and 16 hold the kernel against its plain version at each, and
# phases 15 and 18b time each (n, h, w, cin, cout, residual).
# tests/test_torch_conv_shapes.py runs the packed serving forwards on the
# CPU and fails when a path calls a channel signature missing here; phases
# 14 and 18 fail likewise on the card.
SFF_CONV_CHECKS = (
    (4, 1280, 1280, 2, 32, "relu", None), (4, 1280, 1280, 2, 32, "leaky", None),
    (4, 1280, 1280, 2, 6, "relu", None), (4, 1280, 1280, 6, 6, "relu", None),
    (4, 1280, 1280, 6, 32, "relu", None),
    (4, 1280, 1280, 32, 32, "relu", None), (4, 1280, 1280, 32, 32, "leaky", None),
    (4, 1280, 1280, 32, 32, None, None), (4, 1280, 1280, 32, 32, None, "post"),
    (4, 1280, 1280, 32, 32, "relu", "pre"),
    (4, 1280, 1280, 32, 1, "relu", None), (4, 1280, 1280, 32, 2, None, None),
    (4, 640, 640, 32, 32, "relu", None),
    (4, 640, 640, 32, 64, "relu", None), (4, 640, 640, 32, 64, "leaky", None),
    (4, 640, 640, 64, 64, "relu", None), (4, 640, 640, 64, 64, "leaky", None),
    (4, 640, 640, 64, 64, None, None), (4, 640, 640, 64, 64, None, "post"),
    (4, 640, 640, 64, 64, "relu", "pre"), (4, 640, 640, 64, K, "relu", None),
)
SP_CONV_CHECKS = (
    (2, 1280, 1280, 1, 64, "relu", None), (2, 1280, 1280, 64, 64, "relu", None),
    (2, 1280, 1280, 64, 64, None, None), (2, 1280, 1280, 64, 64, "relu", "pre"),
    (2, 1280, 1280, 64, 1, None, None),
    (2, 640, 640, 64, 128, "relu", None), (2, 640, 640, 128, 128, "relu", None),
    (2, 640, 640, 128, 128, None, None), (2, 640, 640, 128, 128, "relu", "pre"),
    (2, 640, 640, 128, 64, "relu", None),
)
DECONV_CHECKS = (
    (4, 320, 320, 128, 64, "relu", None),
    (4, 320, 320, 128, 64, "relu", "post_act_half"),
    (4, 640, 640, 64, 32, "relu", None),
    (4, 640, 640, 64, 32, "relu", "post_act_half"),
)
# odd sizes and channel counts for the edges of both designs
ODD_CONV_CHECKS = (
    (2, 37, 53, K, K, "leaky", "post"), (2, 37, 53, 32, 32, "relu", "pre"),
    (2, 37, 53, 64, K, "relu", None), (2, 37, 53, 128, 128, "leaky", "post"),
    (2, 37, 53, 100, 90, "relu", "pre"), (2, 37, 53, 48, 24, None, "post"),
)
ODD_DECONV_CHECKS = (
    (2, 37, 53, K, 27, "relu", "post_act_half"),
    (2, 37, 53, 128, 64, "leaky", "post_affine"),
    (2, 37, 53, 64, 32, "relu", "post_act_half"),
)


# The sepconv forward's signatures (n, c, h, w, k, image dtype, maps dtype)
# and the head tail's (n, hi, wi, cx, k) that the paths launch at full
# width: the SFF restore in bfloat16 (both paths) and float32, 4 sections a
# group, its fused head tails on the 640^2 features; the SP restore, batch
# 2; the training step, 32 x 256^2; micro_bench. Then the remaining dtype
# pair, K = 5 and 11, and odd sizes and channel counts that take the first
# designs (sepconv W % 4 != 0; head tail Cx % 8 != 0) or the edges of the
# new ones. Phases 3, 11 and 12 hold both designs against the plain version
# at each; phases 6, 10, 14, 18 and 19a fail on a launched signature
# missing here, and tests/test_torch_conv_shapes.py on a packed path's.
SEPCONV_CHECKS = (
    (4, 1, 1280, 1280, K, "bfloat16", "bfloat16"),
    (4, 1, 1280, 1280, K, "float32", "float32"),
    (2, 1, 1280, 1280, K, "bfloat16", "bfloat16"),
    (32, 1, 256, 256, K, "float32", "float32"),
    (1, 1, 1280, 1280, K, "float32", "float32"),
    (4, 1, 1280, 1280, K, "float32", "bfloat16"),
    (4, 1, 1280, 1280, K, "bfloat16", "float32"),
    (2, 2, 64, 96, 5, "float32", "float32"),
    (2, 3, 61, 48, 11, "float32", "float32"),
    (2, 2, 64, 96, 11, "bfloat16", "bfloat16"),
    (2, 3, 100, 180, K, "bfloat16", "bfloat16"),
    (2, 3, 251, 179, K, "float32", "float32"),
    (2, 3, 251, 179, K, "bfloat16", "bfloat16"),
)
HEAD_TAIL_CHECKS = (
    (4, 640, 640, 64, K),
    (2, 37, 52, 56, K), (1, 9, 4, 64, K), (2, 20, 40, 64, 56),
    (2, 37, 53, K, K), (2, 37, 53, 64, K),
)
# The sepconv backward's signatures, as SEPCONV_CHECKS writes them: the
# training step's (the only one a path launches), then rows for the simple
# design (W % 4 != 0), more channels than one block's shared memory holds,
# bf16 maps and image, and C > 1 at odd H on the blocked design. Phases 8
# and 11 hold both designs against the plain version at each; phase 10
# fails on a launched signature missing here, and
# tests/test_torch_conv_shapes.py on the training step's.
SEPCONV_BWD_CHECKS = (
    (32, 1, 256, 256, K, "float32", "float32"),
    (2, 3, 61, 47, 11, "float32", "float32"),
    (1, 13, 40, 40, K, "float32", "float32"),
    (2, 1, 64, 96, 5, "float32", "bfloat16"),
    (2, 3, 61, 48, 11, "float32", "float32"),
    (2, 1, 37, 52, K, "bfloat16", "bfloat16"),
)
MAP_CHECKS = ({("sepconv", *c) for c in SEPCONV_CHECKS}
              | {("sepconv_bwd", *c) for c in SEPCONV_BWD_CHECKS}
              | {("head_tail", *c) for c in HEAD_TAIL_CHECKS})


def dtype_name(dtype):
    return str(dtype).removeprefix("torch.")


def timing_rows(checks):
    """The distinct (n, h, w, cin, cout, residual) of a check list."""
    return list(dict.fromkeys((n, h, w, ci, co, r)
                              for n, h, w, ci, co, _, r in checks))


class KernelSignatures:
    """Records (kernel, cin, cout, act, residual) of every conv3x3_fused and
    deconv2x_fused call that models/serving.py makes while active, with
    the spatial shape, as a Counter of (kernel, n, h, w, cin, cout, act,
    residual). Residual: None, 'pre' or 'post' for conv3x3, the res_mode
    for deconv2x. The head tails of models/serving.py, the sepconvs of
    models/serving.py, models/ifnet.py and tools/micro_bench.py and the
    sepconv backwards (kernels/sepconv.py's ``_sepconv_bwd``) go into
    ``maps``, a Counter of ('head_tail', n, hi, wi, cx, k), ('sepconv', n,
    c, h, w, k, image dtype, maps dtype) and ('sepconv_bwd', ...) alike, as
    the check lists write them."""

    def __init__(self):
        import collections

        self.calls = collections.Counter()
        self.maps = collections.Counter()

    def __enter__(self):
        from sstem_tpu_torch.kernels import sepconv
        from sstem_tpu_torch.models import ifnet, serving
        from sstem_tpu_torch.tools import micro_bench

        self._serving = serving
        # the modules that call sepconv_planar by name
        self._sep_sites = (serving, ifnet, micro_bench)
        # sepconv_planar_bwd launches through sepconv._sepconv_bwd
        self._sepconv = sepconv
        self._orig = serving.conv3x3_fused, serving.deconv2x_fused
        self._orig_tail = serving.head_tail
        conv, deconv = self._orig
        tail, sep = serving.head_tail, serving.sepconv_planar
        self._orig_bwd = bwd = sepconv._sepconv_bwd

        def tail_rec(x, w3, b3):
            self.maps[("head_tail", *x.shape, w3.shape[3])] += 1
            return tail(x, w3, b3)

        def sep_key(kernel, image, vertical):
            return (kernel, *image.shape[:2], *vertical.shape[2:],
                    vertical.shape[1], dtype_name(image.dtype),
                    dtype_name(vertical.dtype))

        def sep_rec(image, vertical, horizontal):
            self.maps[sep_key("sepconv", image, vertical)] += 1
            return sep(image, vertical, horizontal)

        def bwd_rec(image, vertical, horizontal, grad):
            self.maps[sep_key("sepconv_bwd", image, vertical)] += 1
            return bwd(image, vertical, horizontal, grad)

        serving.head_tail = tail_rec
        for site in self._sep_sites:
            site.sepconv_planar = sep_rec
        sepconv._sepconv_bwd = bwd_rec

        def conv_rec(x, w, scale, shift, act=None, residual=None,
                     residual_pre_affine=False):
            res = None if residual is None else (
                "pre" if residual_pre_affine else "post")
            self.calls[("conv3x3", *x.shape[:3], *w.shape[2:], act, res)] += 1
            return conv(x, w, scale, shift, act, residual, residual_pre_affine)

        def deconv_rec(x, w, scale, shift, act=None, residual=None,
                       res_mode="post_affine"):
            res = None if residual is None else res_mode
            self.calls[("deconv2x", *x.shape[:3], *w.shape[2:], act, res)] += 1
            return deconv(x, w, scale, shift, act, residual, res_mode)

        serving.conv3x3_fused, serving.deconv2x_fused = conv_rec, deconv_rec
        return self

    def __exit__(self, *exc):
        from sstem_tpu_torch.kernels import sepconv_planar

        self._serving.conv3x3_fused, self._serving.deconv2x_fused = self._orig
        self._serving.head_tail = self._orig_tail
        for site in self._sep_sites:
            site.sepconv_planar = sepconv_planar
        self._sepconv._sepconv_bwd = self._orig_bwd
        return False

    def channels(self):
        """{(kernel, cin, cout, act, residual)} of the recorded calls."""
        return {(k[0], *k[4:]) for k in self.calls}

    def map_channels(self):
        """{('head_tail', cx, k)} and {('sepconv' or 'sepconv_bwd', c, k,
        image dtype, maps dtype)} of the recorded map-kernel calls."""
        return {map_channel(k) for k in self.maps}


def map_channel(sig):
    """A head-tail or sepconv (backward) signature without its spatial
    shape."""
    if sig[0] == "head_tail":
        return sig[0], *sig[4:]
    return sig[0], sig[2], *sig[5:]


def check_channels(checks, kernel="conv3x3"):
    """{(kernel, cin, cout, act, residual)} of a check list."""
    return {(kernel, ci, co, a, r) for _, _, _, ci, co, a, r in checks}


def counted_kernels():
    """Every kernel wrapper of the restore paths, by name."""
    from sstem_tpu_torch import kernels

    return {"sepconv_fwd": kernels.sepconv_planar,
            "warp_bilinear": kernels.serving_warp,
            "conv3x3_fused": kernels.conv3x3_fused,
            "pool2x": kernels.pool2x,
            "deconv2x_fused": kernels.deconv2x_fused,
            "head_tail": kernels.head_tail}


def full_size_run(stack, ids, dtype, path="cudnn", chunk=4, profile=False,
                  **options):
    """The bench workload in one dtype on one path. Returns (the kernels'
    launch counts during one restore_stack_scanned call, ms/section, the
    kernel signatures of that call: KernelSignatures); with ``profile``,
    one more call runs under torch.profiler."""
    wrappers = counted_kernels()
    name = f"{str(dtype).removeprefix('torch.')} {path}"
    pipe = build_pipeline("cuda", dtype, **options)
    z, h, w = stack.shape
    groups = -(-len(ids) // chunk)

    # one checked run: outputs finite before quantization, launch counts
    finite = []
    section = pipe.section

    def checked(x3):
        outs = section(x3)
        finite.append(all(bool(torch.isfinite(t).all()) for t in outs))
        return outs

    pipe.section = checked
    for fn in wrappers.values():
        fn.launches = 0
    with KernelSignatures() as sig:
        out = pipe.restore_stack_scanned(stack, ids, chunk=chunk)
        torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    del pipe.section
    say(f"full {name} groups", groups)
    for k, n in launches.items():
        say(f"full {name} {k} launches (per group)", f"{n} ({n / groups})")
    want = {k: PATH_LAUNCHES[path].get(k, 0) * groups for k in wrappers}
    assert launches == want, (launches, want)
    report_signatures(f"full {name}", sig, groups, "group",
                      check_channels(SFF_CONV_CHECKS)
                      | check_channels(DECONV_CHECKS, "deconv2x"))
    assert finite and all(finite), f"{name}: non-finite values before quantization"
    assert sorted(out) == sorted(ids)
    for i in ids:
        for key in ("interp", "fused", "warped", "stitch"):
            assert out[i][key].dtype == np.uint8 and out[i][key].shape == (h, w)
        assert out[i]["flow"].shape == (h, w, 2)
        assert np.isfinite(out[i]["flow"]).all()
    say(f"full {name} interp mean level", float(np.mean([out[i]["interp"] for i in ids])))
    say(f"full {name} fused mean level", float(np.mean([out[i]["fused"] for i in ids])))

    for _ in range(2):
        pipe.restore_stack_scanned(stack, ids, chunk=chunk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        pipe.restore_stack_scanned(stack, ids, chunk=chunk)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1000 / len(ids)
    say(f"full {name} ms_per_section (median of 5)", ms)
    say(f"full {name} ms_per_section runs", [t * 1000 / len(ids) for t in times])
    say(f"full {name} peak_memory_GiB",
        torch.cuda.max_memory_allocated() / 2 ** 30)
    if profile:
        profile_runs(f"full {name}",
                     lambda: pipe.restore_stack_scanned(stack, ids, chunk=chunk),
                     1, len(ids), "section", f"restore_{path}_profile.json")
    del pipe
    torch.cuda.empty_cache()
    return launches, ms, sig


def report_signatures(label, sig, units, unit, checked=frozenset()):
    """Prints each recorded kernel signature with its calls per unit and
    fails when one is not in the check lists: a conv3x3 or deconv2x
    channel signature not in ``checked``, a head-tail or sepconv (backward)
    signature not in HEAD_TAIL_CHECKS, SEPCONV_CHECKS or
    SEPCONV_BWD_CHECKS."""
    for key, n in sorted(sig.calls.items(), key=str):
        say(f"{label} {key[0]} {key[1]}x{key[2]}x{key[3]} {key[4]}->{key[5]} "
            f"act={key[6]} res={key[7]} launches per {unit}", n / units)
    for key, n in sorted(sig.maps.items(), key=str):
        say(f"{label} {key} launches per {unit}", n / units)
    missing = (sig.channels() - checked) | (set(sig.maps) - MAP_CHECKS)
    assert not missing, f"{label}: signatures missing from the checks: {missing}"


def sepconv_bwd_inputs(n, c, h, w, k, image, maps, gen):
    """The forward's inputs (sepconv_inputs) and a zero-mean output gradient
    in the image dtype (SEPCONV_BWD_CHECKS)."""
    grad = (rand((n, c, h, w), gen) - 0.5).to(getattr(torch, image))
    return (*sepconv_inputs(n, c, h, w, k, image, maps, gen), grad)


def check_sepconv_bwd(n, c, h, w, k, image, maps, gen):
    """Both backward designs (the entry point that picks by shape, and the
    simple design's) against the plain version on the same inputs. Returns
    the max abs error of the design the shape picks."""
    from sstem_tpu_torch.kernels import sepconv as sc

    args = sepconv_bwd_inputs(n, c, h, w, k, image, maps, gen)
    want = sc.sepconv_planar_bwd_plain(*args)
    err = {}
    for name, entry in sc.BWD_ENTRY_POINTS.items():
        label = (f"sepconv_bwd {entry} (shape picks {sc.design(w)}) "
                 f"{n}x{c}x{h}x{w} K={k} image={image} maps={maps}")
        err[name] = assert_sepconv_bwd_close(
            label, sc.launch_bwd_entry(entry, *args), want, (n, k, h, w))
    return err[sc.design(w)]


def time_sepconv_bwd(n, c, h, w, k, image, maps, gen, reps=20):
    """The sepconv backward at one signature, by CUDA events, as
    time_sepconv times the forward: the design the entry point picks (ms,
    design), the simple design in the same call (simple_ms), the plain
    version and the bound; no single PyTorch call computes it."""
    from sstem_tpu_torch.kernels import sepconv as sc

    args = sepconv_bwd_inputs(n, c, h, w, k, image, maps, gen)
    size = {"float32": 4, "bfloat16": 2}
    t = timing(cuda_ms(lambda: sc.launch_bwd_entry("sstem_sepconv_bwd", *args),
                       reps, 3),
               cuda_ms(lambda: sc.sepconv_planar_bwd_plain(*args), 2), None,
               sepconv_bound(n, c, h, w, k, size[image], size[maps], True))
    t.update(design=sc.design(w), simple_ms=cuda_ms(
        lambda: sc.launch_bwd_entry(sc.BWD_ENTRY_POINTS["simple"], *args),
        reps, 3))
    return t


def assert_sepconv_bwd_close(label, got, want, shape):
    """The backward kernel's (dV, dH) against the plain version's: 1e-5 of
    the tensor's max |value| in float32, one bf16 ulp of the value in
    bfloat16. Returns the max abs error."""
    torch.cuda.synchronize()
    maps_dtype = want[0].dtype
    err = 0.0
    for name, a, b in zip(("dV", "dH"), got, want):
        assert a.dtype == maps_dtype and a.shape == shape
        d = (a.float() - b.float()).abs()
        err = max(err, float(d.max()))
        say(f"{label} {name} max_abs_err", float(d.max()))
        if maps_dtype == torch.float32:
            # f32 sums of K*K*C terms in another order
            tol = 1e-5 * float(b.abs().max())
            ok = bool(d.max() <= tol)
        else:  # one bf16 ulp of the value: both round once from an f32 sum
            tol = "1 bf16 ulp"
            ok = bool((d <= bf16_ulp(torch.maximum(a.float().abs(),
                                                   b.float().abs()))).all())
        assert ok, f"{label} {name}: kernel disagrees with the plain version (tol {tol})"
    return err


def sepconv_bound(n, c, h, w, k, image_bytes, map_bytes, backward):
    """(bound ms, 'bytes' or 'operations'): each input read once and each
    output written once at the HBM rate, against the kernel's FMAs (2 FLOP
    each) at the float32 peak. Forward: K*K+K FMAs per pixel and channel;
    backward: 2*K*K+2*K per pixel and channel."""
    image = n * c * (h + k - 1) * (w + k - 1) * image_bytes
    plane = n * c * h * w * image_bytes
    maps = n * k * h * w * map_bytes
    if backward:
        nbytes = image + plane + 4 * maps
        flop = 2 * n * c * h * w * (2 * k * k + 2 * k)
    else:
        nbytes = image + 2 * maps + plane
        flop = 2 * n * c * h * w * (k * k + k)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flop / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def train_step_card_vs_cpu(seed=SEED, hw=64, batch=2):
    """One L1 step's loss and gradients of the same IFNet(51) on the card and
    on the CPU. The gradients must agree within 1e-4 of each tensor's max
    |gradient|: both are float32 without TF32, but cuDNN's kernels (FFT and
    Winograd among them) sum in their own order. A sound float32 step has
    measured 2.0e-6; a gradient rounded through bfloat16 anywhere would be
    off by about 2e-3."""
    import copy

    from sstem_tpu_torch import losses
    from sstem_tpu_torch.models import IFNet

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((batch, 6, hw, hw), dtype=np.float32))
    y = torch.from_numpy(rng.random((batch, 1, hw, hw), dtype=np.float32))
    cpu = IFNet(K, generator=torch.Generator().manual_seed(seed))
    card = copy.deepcopy(cpu).cuda()
    grads = []
    for model, dev in ((card, "cuda"), (cpu, "cpu")):
        loss = losses.l1_loss(model(x.to(dev)), y.to(dev))
        loss.backward()
        grads.append((loss.item(), {k: p.grad.cpu() for k, p in model.named_parameters()}))
    (loss_card, g_card), (loss_cpu, g_cpu) = grads
    say("train step card-vs-cpu loss", [loss_card, loss_cpu])
    assert abs(loss_card - loss_cpu) <= 1e-5 * abs(loss_cpu), (loss_card, loss_cpu)
    worst, worst_name = 0.0, None
    for name, want in g_cpu.items():
        rel = float((g_card[name] - want).abs().max() / want.abs().max().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, name
    say("train step card-vs-cpu worst grad err / max|grad|", f"{worst} ({worst_name})")
    assert worst <= 1e-4, (worst, worst_name)


# kernel-name fragments -> kind, first match wins (cuDNN's f32 convolutions
# run as implicit GEMM, FFT or Winograd kernels; an FFT convolution's
# spectra meet in a complex pointwise product)
KERNEL_KINDS = (
    ("sepconv", "sepconv kernels"),
    ("conv3x3_fused", "conv3x3 kernel"), ("conv3x3_wgmma", "conv3x3 kernel"),
    ("deconv2x_fused", "deconv kernel"), ("deconv2x_wgmma", "deconv kernel"),
    ("pool2x_kernel", "pool kernel"), ("head_tail", "head-tail kernel"),
    ("warp_bilinear", "warp kernel"),
    ("multi_tensor_apply", "optimizer"),
    ("conv", "convolution"), ("gemm", "convolution"), ("fft", "convolution"),
    ("mult_and_sum_complex", "convolution"), ("flip_filter", "convolution"),
    ("winograd", "convolution"), ("xmma", "convolution"),
    ("cutlass", "convolution"), ("dgrad", "convolution"),
    ("wgrad", "convolution"), ("cudnn", "convolution"),
    ("upsample", "upsample"), ("pool", "pool"), ("reduce", "reduction"),
    ("memcpy", "copies"), ("memset", "copies"), ("copy", "copies"),
    ("elementwise", "elementwise"),
)


# the trace's categories of work on the device; annotation ranges
# ("gpu_user_annotation") span kernels already counted and are left out
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def profile_steps(train_step, state, batch, steps=2):
    """torch.profiler over ``steps`` training steps (``profile_runs``)."""
    box = [state]

    def step():
        box[0], _ = train_step(box[0], batch)

    profile_runs("train", step, steps, 1, "step", "train_profile.json")


def device_work(prof, trace_name):
    """The device's work (kernels, copies, memsets) in a finished
    torch.profiler run, from its trace exported under ``OUT``."""
    os.makedirs(OUT, exist_ok=True)
    trace = os.path.join(OUT, trace_name)
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        work = [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X" and e.get("cat") in DEVICE_WORK]
    assert work, "the trace holds no device work"
    return work


def profile_runs(label, run, reps, per, unit, trace_name):
    """torch.profiler over ``reps`` calls of ``run`` (``per`` units each):
    wall ms per unit, the device's busy ms per unit (the union of its
    kernel, memcpy and memset intervals in the exported trace), the idle
    share, and device ms per unit by kernel kind."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / (reps * per)
    work = device_work(prof, trace_name)
    units = reps * per
    busy, end = 0.0, float("-inf")  # union of [ts, ts + dur), in us
    for e in sorted(work, key=lambda e: e["ts"]):
        start, stop = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    busy /= 1e3 * units
    total = sum(e["dur"] for e in work) / 1e3 / units
    say(f"{label} profile wall ms per {unit} (profiler on)", wall)
    say(f"{label} profile device busy ms per {unit} (union)", busy)
    say(f"{label} profile device work ms per {unit} (sum)", total)
    say(f"{label} profile idle share", 1 - busy / wall)
    say(f"{label} profile streams with device work",
        sorted({e.get("args", {}).get("stream", e["tid"]) for e in work}))
    assert busy <= wall, (busy, wall)
    kinds, by_name = {}, {}
    for e in work:
        name = e["name"].lower()
        kind = next((k for frag, k in KERNEL_KINDS if frag in name), "other")
        kinds[kind] = kinds.get(kind, 0.0) + e["dur"] / 1e3 / units
        ms, calls = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3 / units, calls + 1)
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        say(f"{label} profile {kind} device ms per {unit} (share of work)",
            f"{ms} ({ms / total})")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    other = [kv for kv in ranked
             if not any(frag in kv[0].lower() for frag, _ in KERNEL_KINDS)]
    for what, rows in (("top kernel", ranked[:8]), ("top other", other[:4])):
        for name, (ms, calls) in rows:
            say(f"{label} profile {what} {name[:90]} ms per {unit} (calls)",
                f"{ms} ({calls // reps})")


def write_interp_config(root, data):
    """The interp trainer's workload as a reference-style YAML config."""
    import yaml

    aug = {"random_fliplr": True, "random_flipud": True, "random_flipz": True,
           "random_rotation": True, "swap": True, "color_jitter": False,
           "COLOR": {"brightness": 0.2, "contrast": 0.2, "saturation": 0.2},
           "elastic_trans": False,
           "ELASTIC": {"alpha_range": 100, "sigma": 10, "shave": 20},
           "gauss_noise": False, "GAUSS": {"gauss_mean": 0, "gauss_sigma": 0.001}}
    cfg = {"NAME": "interp_k51_b32",
           "TRAIN": {"resume": False, "if_valid": True,
                     "cache_path": os.path.join(root, "caches"),
                     "save_path": os.path.join(root, "models"),
                     "loss": "L1", "kernel_size": K, "total_iters": 400000,
                     "warmup_iters": 1000, "base_lr": 1e-4, "end_lr": 1e-6,
                     "decay_iters": 400000, "power": 1.5, "weight_decay": 1e-4,
                     "display_freq": 100, "valid_freq": 1000, "save_freq": 1000,
                     "batch_size": TRAIN_BATCH, "random_seed": SEED},
           "DATA": {"folder_name": data, "train_txt": "train_data.txt",
                    "valid_txt": "valid_data.txt",
                    "patch_size": [TRAIN_PATCH, TRAIN_PATCH], "AUG": aug}}
    path = os.path.join(root, "interp_k51_b32.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def full_width_training(steps=3, timed=10, warm=3):
    """train_interp.main for ``steps`` steps, then the timed step of
    build(cfg). Returns the launch counts of the main() run."""
    from sstem_tpu_torch.cli import train_interp
    from sstem_tpu_torch.compat.config import load_sff_config
    from sstem_tpu_torch.data import write_triplet_tree
    from sstem_tpu_torch.data.providers import InterpTrainDataset, Provider
    from sstem_tpu_torch.kernels import sepconv_planar, sepconv_planar_bwd
    from sstem_tpu_torch.train.trainer import TrainState

    shutil.rmtree(OUT, ignore_errors=True)
    data = os.path.join(OUT, "data")
    rows = write_triplet_tree(data, n_triplets=16, size=320, seed=SEED)
    with open(os.path.join(data, "valid_data.txt"), "w") as f:
        f.write("\n".join(rows[:2]) + "\n")
    cfg_path = write_interp_config(OUT, data)

    sepconv_planar.launches = 0
    sepconv_planar_bwd.launches = 0
    paths = train_interp.main(["-c", cfg_path, "--max-iters", str(steps)])
    torch.cuda.synchronize()
    launches = {"sepconv_fwd": sepconv_planar.launches,
                "sepconv_bwd": sepconv_planar_bwd.launches}
    say("train main steps", steps)
    say("train main sepconv_fwd launches", launches["sepconv_fwd"])
    say("train main sepconv_bwd launches", launches["sepconv_bwd"])
    # 2 per step, plus 2 for the step-1 preview and 2 for each of the two
    # validation images at step 1 (the next validation is at save_freq)
    assert launches == {"sepconv_fwd": 2 * steps + 2 + 2 * 2,
                        "sepconv_bwd": 2 * steps}, launches
    ckpt = os.path.join(paths["save_path"], "model-%06d.ckpt" % steps)
    assert os.path.exists(ckpt), ckpt
    with open(os.path.join(paths["cache_path"], "loss.txt")) as f:
        loss = float(f.read().split("loss = ")[1].split()[0])
    say("train main step-1 loss", loss)
    assert np.isfinite(loss)
    with open(os.path.join(paths["cache_path"], "valid.txt")) as f:
        say("train main valid", f.read().strip().splitlines())

    cfg = load_sff_config(cfg_path)
    model, opt, train_step, _, _ = train_interp.build(cfg, "cuda", seed=SEED)
    state = TrainState(model, opt)
    provider = Provider(InterpTrainDataset(data, patch_size=(TRAIN_PATCH,) * 2),
                        TRAIN_BATCH, seed=SEED, device="cuda")
    try:
        batch = provider.next()
    finally:
        provider.close()
    assert tuple(batch[0].shape) == (TRAIN_BATCH, 6, TRAIN_PATCH, TRAIN_PATCH)
    for _ in range(warm):
        state, metrics = train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sepconv_planar.launches = 0
    sepconv_planar_bwd.launches = 0
    times = []
    with KernelSignatures() as sig:
        for _ in range(timed):
            t0 = time.perf_counter()
            state, metrics = train_step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    report_signatures("train step", sig, timed, "step")
    assert sepconv_planar.launches == 2 * timed, sepconv_planar.launches
    assert sepconv_planar_bwd.launches == 2 * timed, sepconv_planar_bwd.launches
    say("train step sepconv_fwd launches per step", sepconv_planar.launches / timed)
    say("train step sepconv_bwd launches per step", sepconv_planar_bwd.launches / timed)
    loss = float(metrics["loss"])
    assert np.isfinite(loss)
    ms = statistics.median(times) * 1e3
    say(f"train step loss after {warm + timed} steps", loss)
    say(f"train step ms (median of {timed} after {warm} warm)", ms)
    say("train step ms runs", [t * 1e3 for t in times])
    say("train step steps_per_s", 1e3 / ms)
    say("train step MP_per_s", TRAIN_BATCH * TRAIN_PATCH ** 2 / ms / 1e3)
    say("train step peak_memory_GiB", torch.cuda.max_memory_allocated() / 2 ** 30)
    profile_steps(train_step, state, batch)
    return launches


def cuda_ms(fn, reps, warmup=1):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# kernel-name fragments of the probes' split (phase 19b) -> kind
PROBE_KINDS = (
    ("probe_gather", "gather kernel"), ("probe_roll", "roll kernel"),
    ("scatter_gather", "torch.gather kernel"),
    ("roll_cuda", "torch.roll kernel"), ("memcpy", "copies"),
)


def paired_ms(kernel, library, rounds=5, reps=50):
    """CUDA-event ms per call of ``kernel`` and of ``library``: the median
    of ``rounds`` rounds of ``reps`` calls each, the two alternating, so
    that a host that is slower for a while slows both."""
    ms = ([], [])
    for _ in range(rounds):
        for fn, got in zip((kernel, library), ms):
            got.append(cuda_ms(fn, reps, 5))
    return statistics.median(ms[0]), statistics.median(ms[1])


def host_us(fn, reps=200, warmup=20):
    """Host microseconds per call of ``fn``: the host clock around ``reps``
    calls with no synchronise in the loop, after warm-up, from an empty
    queue."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds * 1e6 / reps


def device_us(fn, trace_name, reps=200, warmup=5):
    """Device microseconds per call of ``fn`` by kind (``PROBE_KINDS``),
    from torch.profiler over ``reps`` calls: {kind: us per call}."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kinds = {}
    for e in device_work(prof, trace_name):
        name = e["name"].lower()
        kind = next((k for frag, k in PROBE_KINDS if frag in name), "other")
        kinds[kind] = kinds.get(kind, 0.0) + e["dur"] / reps
    return kinds


def host_device_split(name, kernel, library):
    """Phase 19b's split of one probe case: the host and the device
    microseconds per call of the kernel's wrapper and of the PyTorch call
    beside it, each device time by kind."""
    out = {}
    for key, fn in (("", kernel), ("library_", library)):
        kinds = device_us(fn, "split.json")
        out[f"{key}host_us"] = host_us(fn)
        out[f"{key}device_us"] = sum(kinds.values())
        for kind, us in sorted(kinds.items()):
            say(f"{name} {key}device_us {kind}", us)
    return out


# the card's dense bf16 tensor-core peak (H100 SXM at 700 W), FLOP/s
BF16_FLOP_PER_S = 989e12


def roofline(nbytes, flop, peak):
    """(bound ms, 'bytes' or 'operations'): the bytes at the HBM rate
    against the FLOPs at ``peak``, whichever takes longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flop / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def randn(shape, gen, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=gen, device=DEV) * scale).to(dtype)


def assert_bf16_close(label, got, want):
    """A kernel's bf16 output against its plain version's. Both round once
    to bf16 from f32 sums that differ only in their order, so they may
    differ by one bf16 ulp of the value; where a sum cancels to near zero
    (or an activation meets it there) that order noise, ~1e-6 of the
    summed terms, exceeds an ulp of the small result, so 2^-14 of the
    tensor's max |value| is allowed on top. Returns the max abs error."""
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.bfloat16, (got.dtype, want.dtype)
    assert got.shape == want.shape, (tuple(got.shape), tuple(want.shape))
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ulp = bf16_ulp(torch.maximum(g.abs(), w.abs()))
    floor = 2.0 ** -14 * float(w.abs().max())
    say(f"{label} max_abs_err", float(err.max()))
    say(f"{label} max err / (1 ulp + floor), at most 1",
        float((err / (ulp + floor)).max()))
    say(f"{label} share of outputs off by more than 1 bf16 ulp",
        float((err > ulp).float().mean()))
    assert bool(torch.isfinite(g).all()), f"{label}: non-finite output"
    assert bool((err <= ulp + floor).all()), (
        f"{label}: kernel disagrees with the plain version (1 bf16 ulp + "
        f"2^-14 of max)")
    return float(err.max())


def conv_inputs(n, h, w, cin, cout, gen, residual):
    x = randn((n, h, w, cin), gen)
    wt = randn((3, 3, cin, cout), gen, (2.0 / (9 * cin)) ** 0.5)
    scale = torch.rand(cout, generator=gen, device=DEV) + 0.5
    shift = torch.randn(cout, generator=gen, device=DEV) * 0.1
    res = randn((n, h, w, cout), gen) if residual else None
    return x, wt, scale, shift, res


def check_conv(n, h, w, cin, cout, act, res_mode, gen):
    """conv3x3 kernel vs plain; res_mode None, 'pre' or 'post'."""
    from sstem_tpu_torch.kernels import conv3x3_fused, conv3x3_fused_plain

    x, wt, scale, shift, res = conv_inputs(n, h, w, cin, cout, gen, res_mode)
    pre = res_mode == "pre"
    got = conv3x3_fused(x, wt, scale, shift, act, res, pre)
    want = conv3x3_fused_plain(x, wt, scale, shift, act, res, pre)
    return assert_bf16_close(
        f"conv3x3 {n}x{h}x{w} {cin}->{cout} act={act} res={res_mode}", got,
        want)


def deconv_inputs(n, h, w, cin, cout, gen, residual):
    x = randn((n, h, w, cin), gen)
    wt = randn((3, 3, cin, cout), gen, (2.0 / (2.25 * cin)) ** 0.5)
    scale = torch.rand(cout, generator=gen, device=DEV) + 0.5
    shift = torch.randn(cout, generator=gen, device=DEV) * 0.1
    res = randn((n, 2 * h, 2 * w, cout), gen) if residual else None
    return x, wt, scale, shift, res


def check_deconv(n, h, w, cin, cout, act, res_mode, gen):
    from sstem_tpu_torch.kernels import deconv2x_fused, deconv2x_fused_plain

    x, wt, scale, shift, res = deconv_inputs(n, h, w, cin, cout, gen, res_mode)
    mode = res_mode or "post_affine"
    got = deconv2x_fused(x, wt, scale, shift, act, res, mode)
    want = deconv2x_fused_plain(x, wt, scale, shift, act, res, mode)
    return assert_bf16_close(
        f"deconv2x {n}x{h}x{w} {cin}->{cout} act={act} res={res_mode}", got,
        want)


def check_pool(n, h, w, c, mode, gen):
    """Max is exact and average sums in the plain version's order, so the
    kernel must match it exactly."""
    from sstem_tpu_torch.kernels import pool2x, pool2x_plain

    x = randn((n, h, w, c), gen)
    got = pool2x(x, mode)
    want = pool2x_plain(x, mode)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float((got.float() - want.float()).abs().max())
    say(f"pool2x {n}x{h}x{w}x{c} {mode} max_abs_err", err)
    assert err == 0.0, f"pool2x {mode}: kernel differs from the plain version"
    return err


def head_tail_inputs(n, hi, wi, cx, k, gen):
    x = randn((n, hi, wi, cx), gen)
    w3 = randn((3, 3, k, k), gen, (2.0 / (9 * k)) ** 0.5)
    b3 = torch.randn(k, generator=gen, device=DEV) * 0.1
    return x, w3, b3


def head_tail_module():
    """kernels/head_tail.py (the package's ``head_tail`` name is the
    wrapper function)."""
    import importlib

    return importlib.import_module("sstem_tpu_torch.kernels.head_tail")


def check_head_tail(n, hi, wi, cx, k, gen):
    """Both designs (the entry point that picks by shape, and the mma.sync
    design's) against the plain version, within 2e-2 of the max |value|
    (the hardware gate's tolerance, TPU_CHECKS.json head_tail_fused_640_k51):
    the kernel and F.interpolate may round an upsampled value to different
    bf16 neighbours. Returns the max abs error of the design the shape
    picks."""
    ht = head_tail_module()
    x, w3, b3 = head_tail_inputs(n, hi, wi, cx, k, gen)
    want = ht.head_tail_plain(x, w3, b3)
    errs = {}
    for name, entry in ht.ENTRY_POINTS.items():
        got = ht.launch_entry(entry, x, w3, b3)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (n, k, 2 * hi, 2 * wi)
        err = (got.float() - want.float()).abs()
        rel = float(err.max()) / float(want.float().abs().max())
        label = (f"head_tail {entry} (shape picks {ht.design(wi, cx, k)}) "
                 f"{n}x{hi}x{wi}x{cx} K={k}")
        say(f"{label} max_abs_err", float(err.max()))
        say(f"{label} max_err / max|value|", rel)
        say(f"{label} share of outputs off by more than 1 bf16 ulp", float(
            (err > bf16_ulp(torch.maximum(got.float().abs(),
                                          want.float().abs())))
            .float().mean()))
        assert rel <= 2e-2, f"{label}: kernel disagrees with the plain version"
        errs[name] = float(err.max())
    return errs[ht.design(wi, cx, k)]


# NRMSE limits of the packed path, card vs CPU: both round to bf16 at the
# same points from f32 sums that differ only in order. The fused output
# gets tests/test_serving.py's 0.05: at these random weights its std is
# 0.0020 (half a uint8 level) around a mean of 0.0087, where one bf16 ulp
# (6.1e-5) is 3% of the std, so single-ulp flips read 0.0192 (PERF.md).
PACKED_NRMSE = {"interp": 0.02, "fused": 0.05, "warped": 0.02, "flow": 0.02}


def compare_packed(gpu_sec, cpu_sec, gpu, cpu, ids):
    """The packed path on the card vs on the CPU. Float outputs of one
    group's ``section``: NRMSE below PACKED_NRMSE of each output's std.
    uint8 outputs of restore_stack_scanned: the largest level difference
    and the share of pixels more than 1 level apart are printed."""
    for name, a, b in zip(PACKED_NRMSE, gpu_sec, cpu_sec):
        a = a.float().cpu().double()
        b = b.float().double()
        nrmse = float(((a - b) ** 2).mean().sqrt() / b.std())
        say(f"packed card-vs-cpu {name} nrmse (of std {float(b.std())})", nrmse)
        assert nrmse < PACKED_NRMSE[name], (name, nrmse)
    for key in ("interp", "fused", "warped", "stitch"):
        d = np.abs(np.stack([gpu[i][key] for i in ids]).astype(np.int32)
                   - np.stack([cpu[i][key] for i in ids]).astype(np.int32))
        say(f"packed card-vs-cpu {key} max_level_diff", int(d.max()))
        say(f"packed card-vs-cpu {key} share > 1 level", float((d > 1).mean()))
    flow = max(float(np.abs(gpu[i]["flow"] - cpu[i]["flow"]).max()) for i in ids)
    say("packed card-vs-cpu flow max_abs_err", flow)


def say_timing(name, t):
    for key in ("design", "ms", "mma_ms", "simple_ms", "plain_ms",
                "library_ms", "cudnn_epilogue_ms", "launches_per_unit",
                "host_us", "device_us", "library_host_us",
                "library_device_us"):
        if key in t:
            say(f"{name} {key}", t[key])
    say(f"{name} bound_ms ({t['bound_by']})", t["bound_ms"])


def timing(ms, plain, library, bound):
    """A timed kernel as the JSON line's keys (bound: (ms, 'bytes' or
    'operations'))."""
    return {"ms": ms, "plain_ms": plain, "library_ms": library,
            "bound_ms": bound[0], "bound_by": bound[1]}


def row_launches(calls, kernel, n, h, w, cin, cout, res, units):
    """Launches per unit of one timed shape in a recorded path run."""
    return sum(v for k, v in calls.items()
               if k[0] == kernel and k[1:6] == (n, h, w, cin, cout)
               and k[7] == res) / units


def time_conv_rows(rows, gen, calls, units):
    """conv3x3 at each (n, h, w, cin, cout, residual), by CUDA events: the
    design the C entry point picks (ms), the mma.sync design (its _mma
    entry point, mma_ms), the plain version, the bare cuDNN conv (bf16
    channels-last, library_ms), cuDNN with the epilogue as separate ops,
    the bound, and the launches per unit of the recorded path run."""
    import torch.nn.functional as F

    from sstem_tpu_torch.kernels import conv3x3 as c3

    out = {}
    for n, h, w, cin, cout, res in rows:
        x, wt, scale, shift, r = conv_inputs(n, h, w, cin, cout, gen, res)
        pre = res == "pre"
        x_cl = x.permute(0, 3, 1, 2)
        w_cl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

        def entry(name):
            return lambda: c3.launch_entry(name, x, wt, scale, shift, "relu",
                                           r, pre)

        def cudnn_epilogue():
            y = F.conv2d(x_cl, w_cl, padding=1).float()
            if r is not None and pre:
                y = y + r.permute(0, 3, 1, 2).float()
            y = y * scale[:, None, None] + shift[:, None, None]
            if r is not None and not pre:
                y = y + r.permute(0, 3, 1, 2).float()
            return torch.relu(y).to(torch.bfloat16)

        nbytes = 2 * (n * h * w * (cin + cout * (2 if r is not None else 1))
                      + 9 * cin * cout) + 8 * cout
        t = timing(
            cuda_ms(entry("sstem_conv3x3_fused"), 10, 2),
            cuda_ms(lambda: c3.conv3x3_fused_plain(x, wt, scale, shift,
                                                   "relu", r, pre), 2),
            cuda_ms(lambda: F.conv2d(x_cl, w_cl, padding=1), 10, 2),
            roofline(nbytes, 2 * n * h * w * 9 * cin * cout, BF16_FLOP_PER_S))
        t.update(design=c3.design(cin, cout),
                 mma_ms=cuda_ms(entry(c3.ENTRY_POINTS["mma"]), 10, 2),
                 cudnn_epilogue_ms=cuda_ms(cudnn_epilogue, 5, 1),
                 launches_per_unit=row_launches(calls, "conv3x3", n, h, w, cin,
                                                cout, res, units))
        name = (f"conv3x3_fused[{cin}->{cout}@{n}x{h}x{w}"
                f"{' res ' + res if res else ''}]")
        say_timing(name, t)
        out[name] = t
        del x, wt, r, x_cl, w_cl
    return out


def time_deconv_rows(rows, gen, calls, units):
    """deconv2x at each (n, h, w, cin, cout, residual) as time_conv_rows
    times conv3x3; the library call is the bare F.conv_transpose2d."""
    import torch.nn.functional as F

    from sstem_tpu_torch.kernels import deconv as dc

    out = {}
    for n, h, w, cin, cout, res in rows:
        x, wt, scale, shift, r = deconv_inputs(n, h, w, cin, cout, gen, res)
        mode = res or "post_affine"
        x_cl = x.permute(0, 3, 1, 2)
        w_t = wt.permute(2, 3, 0, 1).contiguous(memory_format=torch.channels_last)

        def entry(name):
            return lambda: dc.launch_entry(name, x, wt, scale, shift, "relu",
                                           r, mode)

        nbytes = 2 * (n * h * w * cin + 9 * cin * cout
                      + 4 * n * h * w * cout * (2 if r is not None else 1)) + 8 * cout
        t = timing(
            cuda_ms(entry("sstem_deconv2x_fused"), 10, 2),
            cuda_ms(lambda: dc.deconv2x_fused_plain(x, wt, scale, shift,
                                                    "relu", r, mode), 2),
            cuda_ms(lambda: F.conv_transpose2d(x_cl, w_t, stride=2, padding=1,
                                               output_padding=1), 10, 2),
            roofline(nbytes, 2 * n * h * w * cin * cout * 9, BF16_FLOP_PER_S))
        t.update(design=dc.design(cin, cout),
                 mma_ms=cuda_ms(entry(dc.ENTRY_POINTS["mma"]), 10, 2),
                 launches_per_unit=row_launches(calls, "deconv2x", n, h, w,
                                                cin, cout, res, units))
        name = f"deconv2x_fused[{cin}->{cout}@{n}x{h}x{w}{' ' + res if res else ''}]"
        say_timing(name, t)
        out[name] = t
        del x, wt, r, x_cl, w_t
    return out


def time_new_kernels(gen, calls, maps, units):
    """Phase 15: conv3x3 and deconv2x at every full-width shape of the SFF
    packed path (time_conv_rows; ``calls``: the packed path's recorded
    signatures over ``units`` groups), then the pool and the head tail
    beside their plain versions, one library call for the same work and
    their bounds; the head tail with both designs, and its launches per
    group from the fused path's recorded ``maps``. Returns {name: timing
    dict}."""
    import torch.nn.functional as F

    from sstem_tpu_torch.kernels import pool2x, pool2x_plain

    ht = head_tail_module()

    out = time_conv_rows(timing_rows(SFF_CONV_CHECKS), gen, calls, units)
    out.update(time_deconv_rows(timing_rows(DECONV_CHECKS), gen, calls, units))
    x = randn((4, 1280, 1280, 32), gen)
    for mode, lib in (("max", F.max_pool2d), ("avg", F.avg_pool2d)):
        nbytes = 2 * 4 * 1280 * 1280 * 32 * 5 // 4
        out[f"pool2x[{mode}]"] = timing(
            cuda_ms(lambda: pool2x(x, mode), 50, 3),
            cuda_ms(lambda: pool2x_plain(x, mode), 5),
            cuda_ms(lambda: lib(x.permute(0, 3, 1, 2), 2), 50, 3),
            roofline(nbytes, 4 * 640 * 640 * 32 * 4, F32_FLOP_PER_S))
    del x
    x, w3, b3 = head_tail_inputs(4, 640, 640, 64, K, gen)
    w3_oihw = w3.permute(3, 2, 0, 1).contiguous()
    b3_bf = b3.to(torch.bfloat16)

    def library():
        up = F.interpolate(x[..., :K].permute(0, 3, 1, 2).contiguous(),
                           scale_factor=2, mode="bilinear", align_corners=True)
        return F.conv2d(up, w3_oihw, b3_bf, padding=1)

    nbytes = 2 * (4 * 640 * 640 * 64 + 9 * K * K + 4 * K * 1280 * 1280) + 4 * K
    flop = 2 * 4 * 1280 * 1280 * K * K * 9
    t = timing(
        cuda_ms(lambda: ht.launch_entry("sstem_head_tail", x, w3, b3), 10, 2),
        cuda_ms(lambda: ht.head_tail_plain(x, w3, b3), 3),
        cuda_ms(library, 10, 2), roofline(nbytes, flop, BF16_FLOP_PER_S))
    t.update(design=ht.design(640, 64, K),
             mma_ms=cuda_ms(lambda: ht.launch_entry(ht.ENTRY_POINTS["mma"], x,
                                                    w3, b3), 10, 2),
             launches_per_unit=maps[("head_tail", 4, 640, 640, 64, K)] / units)
    out["head_tail[K51@4x640^2]"] = t
    del x
    for name in ("pool2x[max]", "pool2x[avg]", "head_tail[K51@4x640^2]"):
        say_timing(name, out[name])
    return out


def group_input(stack, ids):
    """The [prev, next, degraded] float input of one group, edge-padded to
    multiples of 32, as restore_stack_scanned builds it."""
    z, h, w = stack.shape
    p = np.pad(stack, [(0, 0), (0, -h % 32), (0, -w % 32)], mode="edge")
    ix = np.asarray(ids)
    x3 = np.stack([p[ix - 1], p[ix + 1], p[ix]], 1).astype(np.float32) / 255
    return torch.from_numpy(x3)


def packed_phases(gen, stack, ids):
    """Phases 12-15, the packed_conv=True path; ``stack`` and ``ids`` are
    phase 6's. Returns what the kernels' JSON line needs."""
    from sstem_tpu_torch import config
    from sstem_tpu_torch.data import synth_stack

    bf16 = config.SERVING_DTYPE
    out = {}
    phase("12 conv3x3, pool, deconv and head-tail kernels vs plain")
    out["err"] = {
        "conv3x3_fused": max(check_conv(*c, gen)
                             for c in SFF_CONV_CHECKS + ODD_CONV_CHECKS),
        "pool2x": max(
            check_pool(4, 1280, 1280, 32, "max", gen),
            check_pool(4, 1280, 1280, 32, "avg", gen),
            check_pool(2, 37, 53, K, "max", gen),
            check_pool(2, 37, 53, K, "avg", gen)),
        "deconv2x_fused": max(check_deconv(*c, gen)
                              for c in DECONV_CHECKS + ODD_DECONV_CHECKS),
        "head_tail": max(check_head_tail(*c, gen) for c in HEAD_TAIL_CHECKS),
    }

    phase("13 packed path card vs cpu (K=51, bfloat16, 150 x 170)")
    small = synth_stack(5, 150, 170, seed=0)
    x3 = group_input(small, [1, 3])
    secs, outs = [], []
    for dev in (DEV, "cpu"):
        pipe = build_pipeline(dev, bf16, packed_conv=True)
        secs.append(pipe.section(x3.to(dev)))
        outs.append(pipe.restore_stack_scanned(small, [1, 3]))
    compare_packed(secs[0], secs[1], outs[0], outs[1], [1, 3])

    phase("14 full width, packed path: 25 x 1250^2, 12 sections, chunk 4")
    runs = {"cudnn": full_size_run(stack, ids, bf16, profile=True),
            "packed": full_size_run(stack, ids, bf16, "packed",
                                    profile=True, packed_conv=True),
            "packed_fused_tail": full_size_run(
                stack, ids, bf16, "packed_fused_tail", profile=True,
                packed_conv=True, fused_head_tail=True)}
    for path, (_, ms, _) in runs.items():
        say(f"full bfloat16 {path} ms_per_section, this phase", ms)
    out["launches"] = {k: v[0] for k, v in runs.items()}

    phase("15 the kernels' times at full width (CUDA events)")
    out["times"] = time_new_kernels(gen, runs["packed"][2].calls,
                                    runs["packed_fused_tail"][2].maps,
                                    -(-len(ids) // 4))
    return out


# ---------------------------------------------------------------------------
# phases 16-19: the SP quartet restore and the micro-probes
# ---------------------------------------------------------------------------

def he_init_(module, gen):
    """He-uniform conv weights (variance 2 / fan_in), conv biases U(+-0.05)
    and a BatchNorm that does real work (weight 1 + N(0, 0.1), bias and
    running mean N(0, 0.1), running var U(0.5, 1.5)), drawn from ``gen``, as
    the CPU tests' numpy weights are: the U-Nets' activations then keep
    their scale through the ReLUs, where PyTorch's default init shrinks
    them to a near-constant output that hides the kernels."""
    import math

    from torch import nn

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.uniform_(-1, 1, generator=gen).mul_(
                    math.sqrt(6.0 / fan_in))
                m.bias.uniform_(-0.05, 0.05, generator=gen)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.normal_(1.0, 0.1, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    return module


_SP_MODELS = {}


def build_sp_pipeline(device, dtype, seed=SEED, kernel_size=K,
                      packed_conv=False):
    """SPPipeline on seeded random weights: IFNet(K, n_frames=2) with each
    kernel head's last conv rescaled as ``build_pipeline`` does, UNetSP and
    FusionNetSP by ``he_init_`` with the 1x1 output conv scaled by 0.1 and
    its bias set for a mean output of 0.5, so that the outputs are not
    clipped flat. The models are made once per seed (the
    orthogonal init takes seconds) and each pipeline gets copies."""
    import copy

    from sstem_tpu_torch.infer.pipeline import SPPipeline
    from sstem_tpu_torch.models import FusionNetSP, IFNet, UNetSP
    from sstem_tpu_torch.models.ifnet import HEADS

    key = (seed, kernel_size)
    if key not in _SP_MODELS:
        g = torch.Generator().manual_seed(seed)
        vfi = IFNet(kernel_size, n_frames=2, generator=g)
        with torch.no_grad():
            for frame in HEADS[2]:
                for name in frame:
                    head = getattr(vfi, name)
                    head[7].weight.mul_(0.002)
                    head[7].bias.mul_(0.2).add_(
                        1.0 / (kernel_size * 2 ** 0.5))
        nets = he_init_(UNetSP(), g), he_init_(FusionNetSP(), g)
        # outputs around 0.5, mostly inside 0..1: the 1x1 output conv scaled
        # by 0.1 and its bias set so that the mean output on a unit-range
        # probe image is 0.5
        probe = torch.rand((1, 1, 64, 64), generator=g)
        with torch.no_grad():
            for net, args in zip(nets, ((probe,), (probe * 0.5, probe * 0.5))):
                net.eval()
                net.outc.conv.weight.mul_(0.1)
                net.outc.conv.bias.zero_()
                net.outc.conv.bias.fill_(0.5 - float(net(*args).mean()))
        _SP_MODELS[key] = (vfi, *nets)
    return SPPipeline(*copy.deepcopy(_SP_MODELS[key]), device=device,
                      dtype=dtype, packed_conv=packed_conv)


def quartets(stack, masks, base):
    """(img1, img4, deg2, deg3, mask2, mask3) of the quartets starting at
    the section ids ``base``: sections b, b+3 are the intact neighbours,
    b+1 and b+2 the damaged ones with their masks (bench_sp.py:141-145)."""
    b = torch.as_tensor(base, device=stack.device)
    return (stack[b], stack[b + 3], stack[b + 1], stack[b + 2], masks[b + 1],
            masks[b + 2])


SP_OUTPUTS = ("pred1", "pred2", "vfi1", "vfi2", "denoise1", "denoise2")


# NRMSE limit of the SP packed path, card vs CPU, bf16 on both sides: the
# JAX package's bound between its packed forwards and flax
# (tests/test_serving.py). Every SP output ends in a bf16 rounding (the
# sepconvs' and the U-Nets' last conv's outputs) at values of 0.4-0.7, where
# one bf16 ulp (0.0039, one uint8 level) is 5-13% of the outputs' std at
# these weights (0.03-0.08), so single-ulp flips between two f32 sum orders
# alone read 0.02-0.03 (PERF.md, §6).
SP_PACKED_NRMSE = 0.05


def sp_card_vs_cpu():
    """Phase 17: SPPipeline.restore on the card against the CPU on two
    quartets of a 150 x 170 stack, in float32 (TF32 off, 1e-3 abs) and on
    the packed path in bf16 on both sides (NRMSE below SP_PACKED_NRMSE of
    each output's std)."""
    from sstem_tpu_torch import config
    from sstem_tpu_torch.data import synth_stack

    stack = torch.from_numpy(synth_stack(8, 150, 170, seed=SEED))
    rng = np.random.default_rng(SEED)
    masks = torch.from_numpy(np.stack(
        [np.full((150, 170), 128, np.uint8)] * 8))
    masks[2::4] = torch.from_numpy(
        (rng.random((2, 150, 170)) > 0.8).astype(np.uint8) * 255)
    args = quartets(stack, masks, [0, 4])
    for dtype, packed in ((config.PARITY_DTYPE, False),
                          (config.SERVING_DTYPE, True)):
        label = f"sp card-vs-cpu {str(dtype).removeprefix('torch.')}" + (
            " packed" if packed else "")
        outs = [build_sp_pipeline(dev, dtype, packed_conv=packed).restore(
            *(a.to(dev) for a in args)) for dev in (DEV, "cpu")]
        bad = []
        for key in SP_OUTPUTS:
            a = outs[0][key].float().cpu().double()
            b = outs[1][key].float().double()
            assert a.shape == b.shape == (2, 150, 170), (key, a.shape)
            assert bool(torch.isfinite(a).all()), key
            err = float((a - b).abs().max())
            levels = (torch.floor(a * 255) - torch.floor(b * 255)).abs()
            say(f"{label} {key} max_abs_err", err)
            say(f"{label} {key} max_level_diff", int(levels.max()))
            say(f"{label} {key} share > 1 level", float((levels > 1).double().mean()))
            if packed:
                nrmse = float(((a - b) ** 2).mean().sqrt() / b.std())
                say(f"{label} {key} nrmse (of std {float(b.std())})", nrmse)
                say(f"{label} {key} share off by more than 1 bf16 ulp",
                    float(((a - b).abs() > bf16_ulp(torch.maximum(a.abs(), b.abs())))
                          .double().mean()))
                if not nrmse < SP_PACKED_NRMSE:
                    bad.append((key, nrmse))
            elif not err <= 1e-3:
                bad.append((key, err))
        assert not bad, (label, bad)


# launches per batch of 2 quartets on the SP paths (models/serving.py and
# models/ifnet.py): the two-frame IFNet makes 2 sepconvs per frame on both
# paths; on the packed path each of the 4 U-Net forwards (denoise x2,
# fusion x2) makes 11 conv3x3 launches (inc 2, down1 2, up3 and up4 a split
# concat conv of 2 plus conv1, outc 1) and 1 pool (before down1)
SP_LAUNCHES = {"cudnn": {"sepconv_fwd": 4},
               "packed": {"sepconv_fwd": 4, "conv3x3_fused": 44, "pool2x": 4}}
SP_QUARTETS, SP_BATCH, SP_SIZE = 6, 2, 1250


def sp_full_width(path, stack, masks):
    """Phase 18 on one path: the workload bench_sp.py:40-122 defines (6
    quartets of 1250^2, batch 2, K=51, bf16). Returns (launch counts of one
    run, ms per quartet, the KernelSignatures of that run, batches)."""
    from sstem_tpu_torch import config

    wrappers = counted_kernels()
    pipe = build_sp_pipeline("cuda", config.SERVING_DTYPE,
                             packed_conv=path == "packed")
    batches = [list(range(b, b + 4 * SP_BATCH, 4))
               for b in range(0, 4 * SP_QUARTETS, 4 * SP_BATCH)]

    def run():
        return [pipe.restore(*quartets(stack, masks, ids)) for ids in batches]

    for fn in wrappers.values():
        fn.launches = 0
    with KernelSignatures() as sig:
        outs = run()
        torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    name = f"sp full bfloat16 {path}"
    report_signatures(name, sig, len(batches), f"batch of {SP_BATCH}",
                      check_channels(SP_CONV_CHECKS))
    for k, n in launches.items():
        say(f"{name} {k} launches (per batch of {SP_BATCH})",
            f"{n} ({n / len(batches)})")
    want = {k: SP_LAUNCHES[path].get(k, 0) * len(batches) for k in wrappers}
    assert launches == want, (launches, want)
    for out in outs:
        for key in SP_OUTPUTS:
            t = out[key]
            assert t.shape == (SP_BATCH, SP_SIZE, SP_SIZE), (key, t.shape)
            assert bool(torch.isfinite(t).all()), key
    say(f"{name} pred mean level",
        float(torch.stack([o["pred1"] for o in outs]).mean() * 255))
    del outs
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1000 / SP_QUARTETS
    say(f"{name} ms_per_quartet (median of 5)", ms)
    say(f"{name} ms_per_quartet runs", [t * 1000 / SP_QUARTETS for t in times])
    say(f"{name} MP_per_s (2 x 1250^2 output pixels per quartet)",
        2 * SP_SIZE ** 2 / ms / 1e3)
    say(f"{name} peak_memory_GiB", torch.cuda.max_memory_allocated() / 2 ** 30)
    profile_runs(name, run, 1, SP_QUARTETS, "quartet", f"sp_{path}_profile.json")
    del pipe
    torch.cuda.empty_cache()
    return launches, ms, sig, len(batches)


def check_exact(label, got, want):
    """A probe kernel's output against its plain version's: bit-exact (NaN
    where both are NaN)."""
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype, label
    same = bool(torch.equal(got, want)) or bool(
        ((got == want) | (got.isnan() & want.isnan())).all())
    say(f"{label} exact", same)
    assert same, f"{label}: kernel differs from the plain version"
    return 0.0


def check_probe_kernels(gen):
    """Phase 16: the probe kernels (exact) and conv3x3_fused at every SP
    path signature (1 bf16 ulp + 2^-14 of the max) against their plain
    versions, at the SP path's and the probes' shapes, at odd sizes and,
    for the gather and the roll, at every EDGE_CASES row."""
    from sstem_tpu_torch.kernels import (
        roll_dynamic, roll_dynamic_plain, take_along_axis,
        take_along_axis_plain, tile_copy, tile_copy_plain)
    from sstem_tpu_torch.tools import probe_dma_conv, probe_gather

    err = {"pool2x": check_pool(2, 1280, 1280, 64, "max", gen),
           "conv3x3_fused": max(check_conv(*c, gen) for c in SP_CONV_CHECKS)}
    for _, shape in probe_dma_conv.COPY_SHAPES + (("odd", (7, 13, 3)),):
        x = randn(shape, gen)
        check_exact(f"probe_copy {shape}", tile_copy(x, probe_dma_conv.COPY_TY),
                    tile_copy_plain(x))
    for _, shape in (("odd bytes", (1001,)),):
        x = torch.randint(0, 256, shape, generator=gen, device=DEV,
                          dtype=torch.uint8)
        check_exact(f"probe_copy uint8 {shape} ty=3", tile_copy(x, 3),
                    tile_copy_plain(x))
    edges = probe_gather.EDGE_CASES
    for axis, rows, cols in probe_gather.GATHER_CASES + tuple(
            c[1:] for c in edges if c[0] == "gather"):
        src, idx = probe_gather.gather_inputs(axis, rows, cols, DEV, gen)
        idx[0, :3] = torch.tensor([-1, rows + cols, -(rows + cols)])
        check_exact(f"probe_gather axis={axis} {rows}x{cols}",
                    take_along_axis(src, idx, axis),
                    take_along_axis_plain(src, idx, axis))
    rolls = [(rows, cols, shift) for rows, cols in probe_gather.ROLL_CASES
             for shift in (probe_gather.ROLL_SHIFT, -3, 3 * cols + 1)]
    for rows, cols, shift in rolls + [c[1:] for c in edges if c[0] == "roll"]:
        src = torch.rand((rows, cols), generator=gen, device=DEV)
        s = torch.tensor([shift], dtype=torch.int32, device=DEV)
        check_exact(f"probe_roll {rows}x{cols} shift {shift}",
                    roll_dynamic(src, s), roll_dynamic_plain(src, s))
    err.update({"probe_copy": 0.0, "probe_gather": 0.0, "probe_roll": 0.0})
    return err


# launches of the probes' entry points at their defaults: copy 4 shapes x
# (1 check + 3 warm + 8 timed); conv 3 cases x (1 check + 3 + 8); gather 8
# cases and roll 2 x (3 + 6); warp parity 5 cases + bench 2 x (3 + 6);
# micro_bench 2 x (2 warm + 10 timed)
PROBE_LAUNCHES = {"probe_copy": 48, "conv3x3_fused": 36, "probe_gather": 72,
                  "probe_roll": 18, "warp_bilinear": 23, "sepconv_fwd": 24}


def probe_wrappers():
    from sstem_tpu_torch import kernels

    return {"probe_copy": kernels.tile_copy,
            "conv3x3_fused": kernels.conv3x3_fused,
            "probe_gather": kernels.take_along_axis,
            "probe_roll": kernels.roll_dynamic,
            "warp_bilinear": kernels.serving_warp,
            "sepconv_fwd": kernels.sepconv_planar}


def run_probes():
    """Phase 19a: the probes through their entry points (the main() that
    ``python -m sstem_tpu_torch.tools.<probe>`` runs), with every probe
    kernel's count set to 0 just before and read just after."""
    from sstem_tpu_torch.tools import micro_bench, probe_dma_conv, probe_gather

    wrappers = probe_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    with KernelSignatures() as sig:
        assert probe_dma_conv.main([]) == 0
        assert probe_gather.main(["--parity"]) == 0
        assert probe_gather.main(["--bench"]) == 0
        assert micro_bench.main([]) == 0
        torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    report_signatures("probes", sig, 1, "run")
    for k, n in launches.items():
        say(f"probes {k} launches", n)
    assert launches == PROBE_LAUNCHES, (launches, PROBE_LAUNCHES)
    return launches


def time_probe_kernels(gen, err):
    """Phase 19b: each probe kernel at the JAX probes' shapes, by CUDA
    events, beside its plain version, one library call for the same work
    and its bound; the gather and the roll against their library calls in
    alternating rounds (``paired_ms``) and split into host and device
    microseconds per call (``host_device_split``); the sepconv kernel at
    micro_bench's shape is checked against its plain version first (its
    error goes into ``err``). Returns {name: timing dict}."""
    import torch.nn.functional as F

    from sstem_tpu_torch.kernels import (
        conv3x3_fused, conv3x3_fused_plain, fold_affine, roll_dynamic,
        roll_dynamic_plain, sepconv_planar, sepconv_planar_plain,
        take_along_axis, take_along_axis_plain, tile_copy, tile_copy_plain)
    from sstem_tpu_torch.kernels import _build
    from sstem_tpu_torch.kernels import sepconv as sc
    from sstem_tpu_torch.ops import replication_pad_2d
    from sstem_tpu_torch.tools import probe_dma_conv, probe_gather

    out = {}
    for label, shape in probe_dma_conv.COPY_SHAPES:
        x = randn(shape, gen)
        y = torch.empty_like(x)
        nbytes = 2 * x.numel() * x.element_size()
        name = f"probe_copy[{'x'.join(map(str, shape))} bf16]"
        out[name] = timing(cuda_ms(lambda: tile_copy(x, probe_dma_conv.COPY_TY), 20, 3),
                           cuda_ms(lambda: tile_copy_plain(x), 20, 3),
                           cuda_ms(lambda: y.copy_(x), 20, 3),
                           roofline(nbytes, 0, BF16_FLOP_PER_S))
        del x, y
    for c, co, hw in probe_dma_conv.CONV_CASES:
        x = randn((1, hw, hw, c), gen)
        wt = randn((3, 3, c, co), gen, 1.0 / (3 * c))
        scale, shift = fold_affine(co)
        scale, shift = scale.to(DEV), shift.to(DEV)
        w_cl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        nbytes = 2 * (hw * hw * (c + co) + 9 * c * co) + 8 * co
        out[f"conv3x3_fused[probe {c}->{co}@{hw}^2]"] = timing(
            cuda_ms(lambda: conv3x3_fused(x, wt, scale, shift, None), 20, 3),
            cuda_ms(lambda: conv3x3_fused_plain(x, wt, scale, shift, None), 3),
            cuda_ms(lambda: F.conv2d(x.permute(0, 3, 1, 2), w_cl, padding=1), 20, 3),
            roofline(nbytes, 2 * hw * hw * 9 * c * co, BF16_FLOP_PER_S))
        del x, wt, w_cl
    for axis, rows, cols in probe_gather.GATHER_CASES:
        src, idx = probe_gather.gather_inputs(axis, rows, cols, DEV, gen)
        idx64 = idx.long()
        name = f"probe_gather[axis={axis} {rows}x{cols}]"
        kernel = lambda: take_along_axis(src, idx, axis)
        library = lambda: torch.gather(src, axis, idx64)
        ms, library_ms = paired_ms(kernel, library)
        out[name] = timing(
            ms, cuda_ms(lambda: take_along_axis_plain(src, idx, axis), 50, 5),
            library_ms, roofline(12 * rows * cols, 0, F32_FLOP_PER_S))
        out[name].update(host_device_split(name, kernel, library))
    for rows, cols in probe_gather.ROLL_CASES:
        src = torch.rand((rows, cols), generator=gen, device=DEV)
        shift = torch.tensor([probe_gather.ROLL_SHIFT], dtype=torch.int32,
                             device=DEV)
        name = f"probe_roll[{rows}x{cols}]"
        kernel = lambda: roll_dynamic(src, shift)
        library = lambda: torch.roll(src, int(shift.item()), 1)
        ms, library_ms = paired_ms(kernel, library)
        out[name] = timing(
            ms, cuda_ms(lambda: roll_dynamic_plain(src, shift), 50, 5),
            library_ms, roofline(8 * rows * cols + 4, 0, F32_FLOP_PER_S))
        out[name].update(host_device_split(name, kernel, library))
    # the wrappers' floor: the shared launch path alone (ctypes and the
    # launch; no checks, a preallocated output) and the output's allocation
    dst = torch.empty_like(src)
    say(f"launch path host_us (sstem_probe_roll {rows}x{cols}, no checks)",
        host_us(lambda: _build.launch("sstem_probe_roll", src.get_device(),
                                      src.data_ptr(), shift.data_ptr(),
                                      dst.data_ptr(), rows, cols)))
    say(f"torch.empty_like host_us ({rows}x{cols} f32)",
        host_us(lambda: torch.empty_like(src)))
    image = rand((1, 1, 1280, 1280), gen)
    v = rand((1, K, 1280, 1280), gen, 2.0 / K)
    h = rand((1, K, 1280, 1280), gen, 2.0 / K)
    padded = replication_pad_2d(image, K // 2).contiguous()
    err["sepconv_fwd"] = assert_sepconv_close(
        "sepconv micro_bench 1x1x1280x1280 K=51 f32",
        sepconv_planar(padded, v, h), sepconv_planar_plain(padded, v, h),
        (1, 1, 1280, 1280))
    t = timing(
        cuda_ms(lambda: sepconv_planar(padded, v, h), 10, 2),
        cuda_ms(lambda: sepconv_planar_plain(padded, v, h), 2),
        None, sepconv_bound(1, 1, 1280, 1280, K, 4, 4, False))
    t.update(design=sc.design(1280), simple_ms=cuda_ms(
        lambda: sc.launch_entry(sc.ENTRY_POINTS["simple"], padded, v, h), 10, 2))
    out["sepconv_fwd[micro_bench 1x1x1280^2 f32]"] = t
    del image, v, h, padded
    for name, t in out.items():
        say_timing(name, t)
    return out


def time_sp_kernels(gen, sig, batches):
    """Phase 18b: conv3x3 at every full-width shape of the SP packed path
    (time_conv_rows; ``sig``: the packed path's recorded signatures over
    ``batches`` batches), the SP pool beside its plain version,
    F.max_pool2d and its bound, and the SP sepconv with both designs."""
    import torch.nn.functional as F

    from sstem_tpu_torch.kernels import pool2x, pool2x_plain

    out = time_conv_rows(timing_rows(SP_CONV_CHECKS), gen, sig.calls, batches)
    name = f"sepconv_fwd[sp {SP_BATCH}x1x1280^2 bf16]"
    out[name] = time_sepconv(SP_BATCH, 1, 1280, 1280, K, "bfloat16",
                             "bfloat16", gen)
    out[name]["launches_per_unit"] = sig.maps[
        ("sepconv", SP_BATCH, 1, 1280, 1280, K, "bfloat16", "bfloat16")] / batches
    say_timing(name, out[name])
    x = randn((SP_BATCH, 1280, 1280, 64), gen)
    out["pool2x[max C64@2x1280^2]"] = timing(
        cuda_ms(lambda: pool2x(x, "max"), 50, 3),
        cuda_ms(lambda: pool2x_plain(x, "max"), 5),
        cuda_ms(lambda: F.max_pool2d(x.permute(0, 3, 1, 2), 2), 50, 3),
        roofline(2 * x.numel() * 5 // 4, x.numel() * 3 // 4, F32_FLOP_PER_S))
    del x
    say_timing("pool2x[max C64@2x1280^2]", out["pool2x[max C64@2x1280^2]"])
    return out


def sp_and_probe_phases(gen):
    """Phases 16-19. Returns what the kernels' JSON line needs."""
    from sstem_tpu_torch.data import synth_stack

    res = {}
    phase("16 probe kernels and conv3x3 at 128 channels vs plain")
    res["err"] = check_probe_kernels(gen)

    phase("17 SP restore card vs cpu (K=51, 150 x 170, two quartets)")
    sp_card_vs_cpu()

    phase("18 full width SP: 6 quartets of 1250^2, batch 2, K=51, bf16")
    stack = torch.from_numpy(synth_stack(4 * SP_QUARTETS, SP_SIZE, SP_SIZE,
                                         seed=SEED)).to(DEV)
    rng = np.random.default_rng(3)
    masks = torch.from_numpy(
        (rng.random(tuple(stack.shape)) > 0.8).astype(np.uint8) * 255).to(DEV)
    runs = {path: sp_full_width(path, stack, masks)
            for path in ("cudnn", "packed")}
    for path, (_, ms, _, _) in runs.items():
        say(f"sp full bfloat16 {path} ms_per_quartet, this phase", ms)
    say("sp full packed speedup over cudnn", runs["cudnn"][1] / runs["packed"][1])
    res["sp_launches"] = runs["packed"][0]
    del stack, masks
    torch.cuda.empty_cache()
    _, _, sig, batches = runs["packed"]
    res["sp_times"] = time_sp_kernels(gen, sig, batches)

    phase("19 the probes at their JAX shapes (CUDA events)")
    res["probe_launches"] = run_probes()
    res["probe_times"] = time_probe_kernels(gen, res["err"])
    return res


SP_KERNELS = (
    # JSON name prefix, source, TPU kernel body, where its launches come from
    ("conv3x3_fused[probe", "sstem_tpu_torch/csrc/conv3x3_fused.cu",
     "tools/probe_dma_conv.py:84", "probe_launches"),
    ("conv3x3_fused", "sstem_tpu_torch/csrc/conv3x3_fused.cu",
     "sstem_tpu/kernels/conv3x3.py:124", "sp_launches"),
    ("pool2x", "sstem_tpu_torch/csrc/pool2x.cu",
     "sstem_tpu/kernels/pool.py:45", "sp_launches"),
    ("probe_copy", "sstem_tpu_torch/csrc/probe_copy.cu",
     "tools/probe_dma_conv.py:48", "probe_launches"),
    ("probe_gather", "sstem_tpu_torch/csrc/probe_gather.cu",
     "tools/probe_gather.py:134", "probe_launches"),
    ("probe_roll", "sstem_tpu_torch/csrc/probe_roll.cu",
     "tools/probe_gather.py:156", "probe_launches"),
    ("sepconv_fwd[micro_bench", "sstem_tpu_torch/csrc/sepconv_fwd.cu",
     "tools/micro_bench.py:69", "probe_launches"),
    ("sepconv_fwd[sp", "sstem_tpu_torch/csrc/sepconv_fwd.cu",
     "sstem_tpu/kernels/sepconv.py:240", "sp_launches"),
)


def sp_kernel_entries(res):
    """JSON entries of phases 16-19, one per timed shape; the launches are
    the kernel's in the SP packed path's run (phase 18) or in the probes'
    run (phase 19a), all shapes together."""
    entries = []
    times = {**res["sp_times"], **res["probe_times"]}
    for name, t in times.items():
        prefix, source, replaces, where = next(
            k for k in SP_KERNELS if name.startswith(k[0]))
        kernel = name.split("[")[0]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": res[where][kernel],
            "max_abs_err": res["err"].get(prefix, res["err"].get(kernel, 0.0)),
            **t})
    return entries


NEW_KERNELS = (
    # JSON name prefix, kernel, source, TPU kernel body, launches' path
    ("conv3x3_fused", "sstem_tpu_torch/csrc/conv3x3_fused.cu",
     "sstem_tpu/kernels/conv3x3.py:124", "packed"),
    ("pool2x", "sstem_tpu_torch/csrc/pool2x.cu",
     "sstem_tpu/kernels/pool.py:45", "packed"),
    ("deconv2x_fused", "sstem_tpu_torch/csrc/deconv2x_fused.cu",
     "sstem_tpu/kernels/deconv.py:63", "packed"),
    ("head_tail", "sstem_tpu_torch/csrc/head_tail.cu",
     "sstem_tpu/kernels/head_tail.py:174", "packed_fused_tail"),
)


def new_kernel_entries(res):
    """JSON entries of the packed path's kernels, one per timed shape; the
    launches are the kernel's on its path in phase 14 (all shapes)."""
    entries = []
    for kernel, source, replaces, path in NEW_KERNELS:
        for name, t in res["times"].items():
            if name.split("[")[0] != kernel:
                continue
            entries.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": res["launches"][path][kernel],
                "max_abs_err": res["err"][kernel], **t})
    return entries


def ptxas_summary(log):
    """One line per kernel of the Hopper designs (conv3x3 and deconv wgmma,
    head-tail wgmma, sepconv forward and backward blocked) from the build's
    ptxas -v output:
    registers, spills, static shared memory (the dynamic shared memory of
    each wgmma instantiation is its source's plan, PERF.md), and every
    warning that ptxas serialized a kernel's wgmmas."""
    import re

    types = {"13__nv_bfloat16": "bf16", "S2_": "bf16", "f": "f32"}
    name = None
    for line in log.splitlines():
        if "C7520" in line:
            say("ptxas wgmma serialized", line.split("function", 1)[-1].strip())
        if "Compiling entry function" in line:
            m = re.search(r"(conv3x3|deconv2x)_wgmma_kernelILi(\d+)ELi(\d+)", line)
            b = re.search(r"sepconv_(fwd|bwd)_blocked_kernelILi(\d+)E"
                          r"(?:Li(\d+)E)?(\w+?)EEv", line)
            if m:
                name = f"{m.group(1)} wgmma Cin_p={m.group(2)} N={m.group(3)}"
            elif b:
                dts = [types[t] for t in re.findall(r"13__nv_bfloat16|S2_|f",
                                                     b.group(4))]
                k = "any" if b.group(2) == "0" else b.group(2)
                c = {None: "", "0": " C=any"}.get(b.group(3), f" C={b.group(3)}")
                name = f"sepconv {b.group(1)} blocked K={k}{c} image,maps={dts}"
            elif "head_tail_wgmma_kernel" in line:
                name = "head_tail wgmma"
            else:
                name = None
        elif name and ("spill" in line or "Used" in line):
            say(f"ptxas {name}", line.split(":", 1)[-1].strip())


def main():
    global GPU
    phase("1 device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    GPU = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(GPU, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    from sstem_tpu_torch import config
    from sstem_tpu_torch.data import synth_stack
    from sstem_tpu_torch.kernels import _build, serving_warp
    from sstem_tpu_torch.ops.flow import fold_flows
    from sstem_tpu_torch.ops.warp import spatial_transform

    config.disable_tf32()
    print("TF32 off: cudnn.allow_tf32 = cuda.matmul.allow_tf32 = False")

    phase("2 build")
    t0 = time.perf_counter()
    path, log = _build.build()
    _build.library()
    print(log.strip())
    say("build seconds", time.perf_counter() - t0)
    ptxas_summary(log)

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    phase("3 sepconv kernel vs plain, both designs, every SEPCONV_CHECKS row")
    f32, bf16 = config.PARITY_DTYPE, config.SERVING_DTYPE
    sep_err = {c: check_sepconv(*c, gen) for c in SEPCONV_CHECKS}

    phase("4 warp kernel vs plain")
    im = rand((4, 1280, 1280, 1), gen)
    fold = torch.from_numpy(fold_flows(4, 1280, 1280, SEED)).cuda()
    warp_err = check_warp(im, fold, "fold")
    far = (rand((4, 1280, 1280, 2), gen) - 0.5) * (6 * 1280)
    warp_err = max(warp_err, check_warp(im, far, "far-out-of-range"))
    odd = rand((2, 250, 333, 1), gen)
    warp_err = max(warp_err, check_warp(
        odd, (rand((2, 250, 333, 2), gen) - 0.5) * 40, "odd-size"))

    phase("5 pipeline card vs cpu (K=51, float32, TF32 off)")
    small = synth_stack(5, 150, 170, seed=0)
    gpu_out = build_pipeline("cuda", f32).restore_stack_scanned(small, [1, 3])
    cpu_out = build_pipeline("cpu", f32).restore_stack_scanned(small, [1, 3])
    compare_pipelines(gpu_out, cpu_out, [1, 3])

    phase("6 full size: 25 x 1250^2, 12 damaged sections, chunk 4")
    stack = synth_stack(25, 1250, 1250, seed=0)
    ids = list(range(1, 24, 2))
    launches = {"bf16": full_size_run(stack, ids, bf16)[0],
                "f32": full_size_run(stack, ids, f32)[0]}

    phase("7 kernel times (CUDA events)")
    times = {}
    for name, dt in (("f32", "float32"), ("bf16", "bfloat16")):
        times[f"sepconv_{name}"] = time_sepconv(4, 1, 1280, 1280, K, dt, dt, gen)
        say_timing(f"sepconv_fwd[{name} 4x1x1280^2]", times[f"sepconv_{name}"])
    ms = cuda_ms(lambda: serving_warp(im, fold), reps=20)
    plain = cuda_ms(lambda: spatial_transform(im, fold), reps=5)
    say("warp 4x1280x1280 fold kernel_ms", ms)
    say("warp 4x1280x1280 fold plain_ms", plain)
    times["warp"] = (ms, plain)

    phase("8 sepconv backward kernel vs plain, both designs, "
          "SEPCONV_BWD_CHECKS")
    # the training signature (the first row) is phase 11's
    for c in SEPCONV_BWD_CHECKS[1:]:
        check_sepconv_bwd(*c, gen)

    phase("9 IFNet training step card vs cpu (K=51, 64^2, float32, TF32 off)")
    train_step_card_vs_cpu()

    phase("10 full width training: IFNet K=51, 256^2, batch 32, L1, AdamW")
    train_launches = full_width_training()

    phase("11 sepconv kernels vs plain and their times at the training shape")
    n, hw = TRAIN_BATCH, TRAIN_PATCH
    fwd_train_err = check_sepconv(n, 1, hw, hw, K, "float32", "float32", gen)
    times["sepconv_fwd_train"] = time_sepconv(n, 1, hw, hw, K, "float32",
                                              "float32", gen, reps=20)
    say_timing(f"sepconv_fwd[train {n}x1x{hw}^2 f32]", times["sepconv_fwd_train"])
    train_sig = SEPCONV_BWD_CHECKS[0]
    assert train_sig == (n, 1, hw, hw, K, "float32", "float32"), train_sig
    bwd_train_err = check_sepconv_bwd(*train_sig, gen)
    times["sepconv_bwd"] = time_sepconv_bwd(*train_sig, gen)
    say_timing(f"sepconv_bwd[train {n}x1x{hw}^2 f32]", times["sepconv_bwd"])

    packed = packed_phases(gen, stack, ids)
    del stack
    sp = sp_and_probe_phases(gen)

    kernels = []
    for name, dt in (("f32", "float32"), ("bf16", "bfloat16")):
        kernels.append({
            "name": f"sepconv_fwd[{name}]", "route": "cuda",
            "source": "sstem_tpu_torch/csrc/sepconv_fwd.cu",
            "replaces": "sstem_tpu/kernels/sepconv.py:240",
            "launches": launches[name]["sepconv_fwd"],
            "max_abs_err": sep_err[(4, 1, 1280, 1280, K, dt, dt)],
            **times[f"sepconv_{name}"]})
    warp_bytes = 4 * 1280 * 1280 * (4 + 8 + 4)  # im, flow in; out
    kernels.append({
        "name": "warp_bilinear", "route": "cuda",
        "source": "sstem_tpu_torch/csrc/warp_bilinear.cu",
        "replaces": "sstem_tpu/kernels/warp_band.py:64",
        "launches": sum(v["warp_bilinear"] for v in launches.values()),
        "max_abs_err": warp_err, "ms": times["warp"][0],
        "plain_ms": times["warp"][1],
        "bound_ms": warp_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None})
    kernels.append({
        "name": "sepconv_fwd[train_f32]", "route": "cuda",
        "source": "sstem_tpu_torch/csrc/sepconv_fwd.cu",
        "replaces": "sstem_tpu/kernels/sepconv.py:240",
        "launches": train_launches["sepconv_fwd"],
        "max_abs_err": fwd_train_err, **times["sepconv_fwd_train"]})
    kernels.append({
        "name": "sepconv_bwd", "route": "cuda",
        "source": "sstem_tpu_torch/csrc/sepconv_bwd.cu",
        "replaces": "sstem_tpu/kernels/sepconv.py:287",
        "launches": train_launches["sepconv_bwd"],
        "max_abs_err": bwd_train_err, **times["sepconv_bwd"]})
    kernels += new_kernel_entries(packed)
    sp["err"]["sepconv_fwd[sp"] = sep_err[(SP_BATCH, 1, 1280, 1280, K,
                                           "bfloat16", "bfloat16")]
    kernels += sp_kernel_entries(sp)
    for kern in kernels:
        say(f"{kern['name']} bound_ms ({kern['bound_by']})", kern["bound_ms"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
