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
  4. warp kernel vs its plain PyTorch version at every WARP_CHECKS shape
     (fold flows; the fusion step's from degrade_sff_batch; far out of range)
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
     launches at full width (SFF_CONV_CHECKS, DECONV_CHECKS: conv3x3's
     wgmma, narrow_in and narrow_out designs) and at odd sizes for the
     edges of every design (ODD_CONV_CHECKS); the head tail's two designs
     at every HEAD_TAIL_CHECKS row
 13. the packed_conv=True pipeline on the card vs on the CPU (K=51, bfloat16
     on both sides): NRMSE of each float output, uint8 level differences
 14. phase 6's workload in bfloat16 on the packed_conv=True path, with the
     head tails on cuDNN and on the head-tail kernel, beside the cuDNN path:
     launch counts per group asserted, signatures checked, ms/section, peak
     memory, and one call under torch.profiler each
 15. every conv3x3 and deconv shape of the SFF packed path at full width
     (CUDA events): the design the kernel picks and the mma.sync design in
     alternating rounds, the plain version, the bound, the bare cuDNN call
     and (conv) cuDNN with the epilogue as separate ops, and the launches
     per group;
     then the pool, and the head tail (both designs) beside theirs
 16. the probe kernels (tile copy, gather, dynamic roll; exact, the tile
     copy also at tools/probe_dma_conv.py: COPY_EDGE_CASES, the gather and
     roll at the edge cases of tools/probe_gather.py: EDGE_CASES) and
     conv3x3 at every SP path signature (SP_CONV_CHECKS) vs their plain
     versions
 17. the SP restore on the card vs on the CPU (K=51, two quartets of
     150 x 170): SPPipeline in float32 with TF32 off, and in bfloat16 on
     both sides the packed path and the served path (``ServedSP``: the
     two-frame ``ifnet_serve`` and the U-Nets' serving forwards, head tails
     on cuDNN and on the head-tail kernel)
 18. full width SP: bench_sp.py's workload (6 quartets of 1250^2, batch 2,
     K=51, bfloat16) on the cuDNN, the packed and the two served paths
     (SP_PATHS): launch counts per batch asserted, signatures checked,
     ms/quartet, MP/s, peak memory, one run under torch.profiler each; then
     every conv3x3 shape of the SP served path timed as in phase 15, the
     SP pool, the SP sepconv and the SP head tail with both designs
 19. the probes through their entry points (probe_dma_conv, probe_gather
     --parity and --bench, micro_bench) with launch counts asserted and
     micro_bench's sepconv signature checked, then each probe kernel at the
     JAX probes' shapes beside its plain version, its library call and its
     bound (CUDA events; the sepconv with both designs); the tile copy,
     gather and roll, and copy_ / torch.gather / torch.roll beside them,
     timed in alternating rounds and split into host and device
     microseconds per call
 20. the SFF inference CLIs: ``infer_interp.main`` then
     ``infer_fusion.main`` on a 9 x 1250^2 stack written as PNGs, 4
     damaged sections, seeded reference-format checkpoints, on the float32
     path and with --packed-conv, each twice: launch counts asserted
     (sepconv 2 and warp 1 per section), output shapes, and the average
     inference time per section
 21. the SFF training chain at full width on a seeded triplet tree of
     16 x 512^2: ``infer_interp_trainingset.main -bs 4`` (sepconv 2 a
     batch), ``train_interp.main --device-datagen`` (3 steps of phase 10's
     workload, the triplets as a pool on the card), ``train_unfolding.main``
     and ``train_fusion.main`` (behind the unfolding run's checkpoint) for 3
     steps each on the host and the device datagen paths, and a resume of
     the fusion run with --resume-from (optimizer state checked), launches
     asserted and signatures checked per run; then the step of each
     ``build(cfg)`` at bench.py:394-399's unfolding workload (FusionNet ngf
     32, batch 8, 400^2 crops to 256^2, L1, AdamW, float32, TF32 off) and
     the fusion step at the same shapes (UNetSFF behind the frozen flow
     net), on both datagen paths: ms/step, steps/s, MP/s, peak memory,
     launches per step (warp 1 a fusion step asserted), 2 steps under
     torch.profiler (device busy time, idle share, device ms by kind)
 22. ``infer_unfolding.main`` (float32, test mode) on phase 20's stack with
     its damaged sections folded from the seed, and
     ``infer_interp_single.main`` on one 1250^2 pair, each twice: warp 1 a
     section and sepconv 2 a pair asserted, signatures checked, output
     shapes, the average flow and warp ms a section, and the flow net's EPE
     against the synthesized flow (finite); then the warp and sepconv at
     the new paths' shapes beside their plain versions and bounds
 23. the SP trainers at full width on a seeded quartet tree of 8 x 512^2
     (write_quartet_tree): ``train_sp_interp.main``,
     ``train_sp_correction.main`` and ``train_sp_fusion.main`` (its vfi and
     denoise branches pretrained from the first two runs' checkpoints) for
     3 steps each at the JAX trainers' defaults (256^2 crops, batch 1,
     K=51, Adam, float32, TF32 off), then ``train_sp_interp --resume-torch``
     from its step-1 checkpoint: launches asserted (sepconv forward 4 and
     backward 4 a step in interp and fusion, 4 forwards a preview, none in
     correction), signatures checked, the fusion run's VFI branch
     bit-identical to the checkpoint it loaded; each ``build(cfg)`` step on
     the card against the CPU at 2 x 64^2 (loss, gradients within
     SP_GRAD_BOUNDS, BN statistics), then timed with a profile; then both
     sepconv kernels at the trainers' signature beside their plain
     versions and bounds
 24. the data tools and the perceptual loss: ``simulate_sff.main`` (1024^2
     crops, noise on) on 4 clean 1250^2 sections and ``simulate_sp.main
     --synthetic-bank 24`` on sections 2 and 3 of 4 quartets at 1250^2
     (host seconds a section, no kernel launched); ``gen_data_txt.main
     --dialect sp`` on that tree and ``train_sp_correction.main`` for 3
     steps on it; ``gen_data_txt.main --dialect sff`` on a 16 x 512^2
     triplet tree, the valid set's items in memory (make_validset's HDF5
     sidecars need h5py, which the card's machine lacks) and
     ``train_unfolding.main`` for 3 steps (its preview's warp asserted),
     its checkpoint's EPE over the valid items finite;
     ``train_interp.main`` with TRAIN.loss perceptual and --vgg-weights (a
     seeded VGG19 file in torchvision's layout) for 3 steps at phase 10's
     workload (sepconv forward 2 and backward 2 a step asserted,
     signatures phase 10's), then the steps of ``build(cfg)`` with L1 and
     with the perceptual loss timed in one call with profiles, no gradient
     on a VGG parameter; then the perceptual loss and its gradient,
     MS-SSIM, metrics.psnr and metrics.ssim and the three GAN modes on the
     card against the CPU at 2 x 1 x 64^2 within LOSS_CHECK_BOUNDS
 25. the mesh restores on the one card, its device repeated in each mesh
     (a copy between two distinct cards cannot run on one): phase 6's
     stack through ``restore_stack_sharded`` data-parallel (dp 2, halo 0)
     on the cuDNN bf16 path and the packed path with fused tails, against
     ``restore_stack`` on the same zero-padded canvas within a uint8 level
     on under 1e-3 of pixels, then dp 2 x sp 2 with halo 256 (1408 x 1280
     slabs), both timed (ms/section, median of 3), launches per slab
     asserted; the CPU pipeline's dp 2 x sp 2 call at 2 x 256^2 (K=51,
     halo 64, float32) on a card mesh against a CPU mesh, with
     ``enable_nan_checks`` on; ``infer_tiled`` of the section function
     (tile 512, halo 64, float32) with no mesh and a 2-device mesh, the two
     within a uint8 level, timed beside ``infer_full``; ``profile_trace``
     around one call, its trace read back; the phase's ``StepTimer``
     report; then every kernel of the sharded path at its slab shape
     beside its plain version, library call and bound
 26. data-parallel SFF training on DDP, every rank on cuda:0 under gloo
     (NCCL cannot run two ranks on one card; the card's machine has one):
     (a) ``train_interp.build`` at phase 10's workload (IFNet K=51, a
     global batch of 32 x 256^2 from the seed, float32, TF32 off, L1) on
     2 ranks x 16 rows against the one-process step on the same card: the
     ReLU inputs of each rank's rows against the one-process forward
     (flips only within the two forwards' rounding), step 1's averaged
     gradient against the one-process gradient of the global batch taken
     in two 16-row halves (DDP_GRAD_BOUND) and in one 32-row pass
     (DDP_KINK_GRAD_BOUND), the ranks' parameters bitwise equal after 3
     steps, sepconv forward 2 and backward 2 a step a rank, both timed
     (the ranks share the card: no scaling figure); (b) in the same group,
     ``train_unfolding.main`` and ``train_fusion.main`` with
     --device-datagen (raw crops, one provider thread) at
     bench.py:394-399's workload, 4 rows a rank, against the one-process
     mains: loss.txt (DDP_LOSS_RTOL), checkpoint keys, a warp a fusion
     step a rank; (c) a DDP step under NCCL at world 1 against the plain
     step (NCCL_GRAD_BOUND), while (d) ``dryrun.dryrun_multichip(2)`` and
     ``dryrun.entry()`` run; then the sepconv kernels at a rank's
     signature and the warp at a rank's fusion step beside their plain
     versions and bounds
 27. the matmul-precision policy (``config.set_matmul_precision``) and the
     quality tools: (a) in a fresh process started from torch's own flags,
     with both TF32 flags raised before each, ``SFFPipeline(dtype=
     PARITY_DTYPE)`` and ``infer_interp.main`` on the card leave both
     False, phase 5's restore holds phase 5's bounds against the CPU, and
     its largest level difference is printed beside the same restore with
     TF32 forced on; (b) ``train_interp.build``'s step at phase 10's
     workload under ``highest``, ``high`` and ``default``: loss, the worst
     gradient difference from ``highest`` (``default`` must differ) and
     ms/step (median of POLICY_STEPS after POLICY_WARM; informative, no
     bound); (c) ``quality_run --device-datagen`` (16 triplets of 384^2,
     QUALITY_ITERS a stage, K=51, ngf 32, 768^2 eval sections),
     ``quality_run_sp`` (8 quartets of 320^2, 2 eval quartets of 512^2),
     ``quality_check --packed-conv`` on the SFF run's checkpoints and
     ``diagnose_fusion`` on its root: stage.json keys, finite report rows,
     launches (sepconv forward and backward in the interp steps, a warp a
     fusion step, conv3x3, pool and deconv in the bf16 column) asserted
     and signatures checked; the bf16 deltas printed, not gated; then each
     kernel at the shapes the tools add beside its plain version, library
     call and bound
 28. the compute-dtype policy (``config.set_compute_dtype``): (a) both
     sepconv kernels at the bf16 training signatures (BF16_TRAIN_SIG,
     BF16_SP_TRAIN_SIG; phases 3 and 8 hold both designs against the
     plain versions there) timed beside their bounds; (b) one L1 step of
     IFNet(51) at 2 x 64^2 under "default" + "bfloat16" on the card
     against the CPU, and the CPU's float32 step, within
     DTYPE_CHECK_BOUNDS; (c) bench.py's interp cell (IFNet K=51, 32 x
     256^2, L1, AdamW) and unfolding cell (FusionNet ngf 32, batch 8 of
     400^2 crops from a uint8 pool on the card, degraded and cut to 256^2)
     under each of DTYPE_SETTINGS in this call: ms/step, peak memory, idle
     share and device ms by kind, sepconv 2 + 2 an interp step asserted,
     a 20-step loss trajectory from the seed; (d) the six trainers'
     ``main`` for 3 steps each under the policy: launches asserted,
     signatures checked, checkpoints float32 only, the compute dtype
     still bfloat16 afterwards
 29. the on-card tools and the batched head tail: (a)
     ``tools.gpu_checks.run_checks()`` (the JAX tools/tpu_checks.py cases:
     each kernel against its plain version on the card), every case
     printed, all within tolerance, GPU_CHECKS.json written, every counted
     kernel launched; (b) the six profilers' functions (profile_pipeline,
     profile_serve, profile_fine, ifnet_prefix_bench, micro_conv_bench,
     bench_conv3x3) at their tools' full-width shapes with fewer calls
     (PROFILER_CALLS), every row printed; (c) the packed restore with
     ``batched_head_tail=True`` card vs CPU at phase 13's bounds, then
     phase 14's workload on the unfused, fused and batched tails in turn
     (launches per group asserted, signatures checked, ms/section, peak
     memory); (d) ``tools.verify_drive.main`` in process, exit 0 asserted

Every number is printed on its own line beside the card's name and power
limit. The line before the last is the kernels' JSON summary; the last line
is {"ok": true, "device": {...}}. Weights are random, made from seeds; this
script imports nothing of JAX. What it writes goes under ``build/chip_smoke/``
in the checkout.
"""

import contextlib
import functools
import importlib.util
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


def warp_inputs(n, h, w, gen):
    """A unit-range image and a flow at one WARP_CHECKS shape: the fusion
    step's flows from degrade_sff_batch on seeded 400^2 crops (line width
    5..20, as the fusion trainer draws them; a data-parallel rank's batch
    too), random +-20 px at the odd size, fold flows (ops.flow.fold_flows)
    elsewhere."""
    from sstem_tpu_torch.data import synth_stack
    from sstem_tpu_torch.data.sim_sff import degrade_sff_batch, step_generator
    from sstem_tpu_torch.ops.flow import fold_flows

    im = rand((n, h, w, 1), gen)
    if (h, w) == (SFF_TRAIN_DET, SFF_TRAIN_DET) and n > 1:
        crops = torch.from_numpy(synth_stack(n, SFF_TRAIN_CROP, SFF_TRAIN_CROP,
                                             seed=SEED)).cuda()
        _, flow = degrade_sff_batch(crops, step_generator(SEED, 1, "cuda"),
                                    det_size=h, line_width_range=(5, 20))
        return im, flow.contiguous()
    if (n, h, w) == (2, 250, 333):
        return im, (rand((n, h, w, 2), gen) - 0.5) * 40
    return im, torch.from_numpy(fold_flows(n, h, w, SEED)).cuda()


def build_pipeline(device, dtype, seed=SEED, kernel_size=K, **options):
    """SFFPipeline on seeded random weights. The kernel heads' last conv is
    rescaled so each frame's taps sum to about 1/sqrt(2), as a trained KPN's
    do; otherwise the interp saturates at the clip and hides the sepconv.
    ``options`` go to SFFPipeline (packed_conv, fused_head_tail,
    batched_head_tail)."""
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
    # the four head tails in one cuDNN upsample and grouped conv (phase 29)
    "packed_batched_tail": {"sepconv_fwd": 2, "warp_bilinear": 1,
                            "conv3x3_fused": 50, "pool2x": 3,
                            "deconv2x_fused": 4},
}


# The conv3x3_fused and deconv2x_fused signatures (n, h, w, cin, cout, act,
# residual) that the packed paths launch at full width: the SFF restore on
# its 1280^2 canvas, 4 sections a group; the SP restore at 1280^2, batch 2
# (the served path's two-frame IFNet first, then the U-Nets').
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
    (2, 1280, 1280, 2, 6, "relu", None), (2, 1280, 1280, 6, 6, "relu", None),
    (2, 1280, 1280, 6, 32, "relu", None), (2, 640, 640, 32, 32, "relu", None),
    (2, 640, 640, 32, 64, "relu", None), (2, 640, 640, 64, 64, "relu", None),
    (2, 640, 640, 64, K, "relu", None),
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
# odd sizes and channel counts for the edges of every design: wgmma, mma
# (K -> K, 100 -> 90), narrow_in (Cin 1, 2, 3, 6: odd and even Cin, each
# K and N width but K 64 x N 64, residual by loads and by cp.async) and
# narrow_out (Cin 16 to 128, Cout 1, 2, 6, 8)
ODD_CONV_CHECKS = (
    (2, 37, 53, K, K, "leaky", "post"), (2, 37, 53, 32, 32, "relu", "pre"),
    (2, 37, 53, 64, K, "relu", None), (2, 37, 53, 128, 128, "leaky", "post"),
    (2, 37, 53, 100, 90, "relu", "pre"), (2, 37, 53, 48, 24, None, "post"),
    (2, 37, 53, 1, 64, "relu", None), (2, 37, 53, 2, 32, "leaky", "post"),
    (2, 37, 53, 3, 16, "relu", None), (2, 37, 53, 6, 6, "relu", "pre"),
    (2, 37, 53, 32, 1, "relu", None), (2, 37, 53, 64, 2, None, "post"),
    (2, 37, 53, 128, 6, "leaky", None), (2, 37, 53, 16, 8, None, "pre"),
)
ODD_DECONV_CHECKS = (
    (2, 37, 53, K, 27, "relu", "post_act_half"),
    (2, 37, 53, 128, 64, "leaky", "post_affine"),
    (2, 37, 53, 64, 32, "relu", "post_act_half"),
)


# The SFF correction and fusion trainers' workload (bench.py:394-399:
# batch 8 of 400^2 crops degraded and centre-cropped to 256^2), and
# infer_interp_trainingset's over a triplet tree of 16 x 512^2, 4 rows a
# call (phase 21).
SFF_TRAIN_BATCH, SFF_TRAIN_CROP, SFF_TRAIN_DET = 8, 400, 256
TRAININGSET_ROWS, TRAININGSET_SIZE, TRAININGSET_BS = 16, 512, 4

# Data-parallel training (phase 26): two ranks on the one card, each taking
# its half of the interp trainer's batch (TRAIN_BATCH x TRAIN_PATCH^2) and of
# the correction and fusion trainers' (SFF_TRAIN_BATCH); a rank's sepconv
# signature, forward and backward, and its fusion step's warp shape.
DDP_WORLD = 2
DDP_INTERP_SIG = (TRAIN_BATCH // DDP_WORLD, 1, TRAIN_PATCH, TRAIN_PATCH, K,
                  "float32", "float32")
DDP_WARP = (SFF_TRAIN_BATCH // DDP_WORLD, SFF_TRAIN_DET, SFF_TRAIN_DET)

# The SP trainers' workload: the JAX trainers' defaults (patch_size or 256,
# batch_size or 1, kernel_size or 51, base_lr or 1e-4; the reference's SP
# YAMLs are not in the repo) over a seeded quartet tree of
# SP_TRAIN_ROWS x SP_TRAIN_SIZE^2; the card-vs-CPU steps at 2 x
# SP_CHECK_PATCH^2.
SP_TRAIN_ROWS, SP_TRAIN_SIZE, SP_TRAIN_PATCH, SP_TRAIN_BATCH = 8, 512, 256, 1
SP_CHECK_PATCH = 64
# the SP trainers' sepconv signature, forward and backward (2 frames x 2
# sepconvs a step in train_sp_interp and train_sp_fusion, and their
# previews)
SP_TRAIN_SIG = (SP_TRAIN_BATCH, 1, SP_TRAIN_PATCH, SP_TRAIN_PATCH, K,
                "float32", "float32")
# The same trainers under the bf16 compute dtype (phase 28,
# config.set_compute_dtype("bfloat16")): bf16 frames and bf16 tap maps,
# forward and backward
BF16_TRAIN_SIG = (TRAIN_BATCH, 1, TRAIN_PATCH, TRAIN_PATCH, K, "bfloat16",
                  "bfloat16")
BF16_SP_TRAIN_SIG = SP_TRAIN_SIG[:5] + ("bfloat16", "bfloat16")

# The quality tools' signatures (phase 27c, QUALITY_ARGS and
# QUALITY_SP_ARGS): the sepconv forward's in quality_run (the interp steps,
# 4 x 256^2; infer_interp_trainingset, 4 x 384^2; the eval restore of 3
# sections of 768^2 in float32 and on the packed bf16 path), in
# quality_run_sp (the VFI and fusion steps, 8 x 128^2, and the VFI
# preview's row; the eval quartets' interps at 512^2) and in quality_check
# (one 512^2 section on the packed path); the backward's in the interp and
# SP steps; the warp's in the fusion steps (16 x 256^2), the eval restore
# and quality_check. Each tool's run, whose launches the JSON line counts.
_F32, _BF16 = ("float32", "float32"), ("bfloat16", "bfloat16")
QUALITY_SEPCONV = (
    (4, 1, 256, 256, K) + _F32, (4, 1, 384, 384, K) + _F32,
    (3, 1, 768, 768, K) + _F32, (3, 1, 768, 768, K) + _BF16,
    (8, 1, 128, 128, K) + _F32, (1, 1, 128, 128, K) + _F32,
    (1, 1, 512, 512, K) + _F32, (1, 1, 512, 512, K) + _BF16,
)
QUALITY_SEPCONV_TOOLS = ("quality_run",) * 4 + ("quality_run_sp",) * 3 + (
    "quality_check",)
QUALITY_SEPCONV_BWD = ((4, 1, 256, 256, K) + _F32,
                       (8, 1, 128, 128, K) + _F32)
QUALITY_WARPS = ((16, 256, 256), (3, 768, 768), (1, 512, 512))
QUALITY_WARP_TOOLS = ("quality_run", "quality_run", "quality_check")

# The serving warp's shapes (n, h, w) that the paths launch: the SFF restore
# (4 sections a group on the 1280^2 canvas), the fusion trainer's step
# (SFF_TRAIN_BATCH x 256^2) and the trainers' previews (one 256^2 crop),
# infer_unfolding (one 1250^2 section) and infer_fusion (one section on its
# 1280^2 canvas); the sharded restore's slabs (phase 25: 1408 x 1280, 320
# x 256) and the tiled restore's tiles (4 or 2 of 640^2); then an odd size.
# Phase 4 holds the kernel against its plain version at each;
# phases 21, 22, 25 and 26 fail on a launched shape missing here, and
# tests/test_torch_conv_shapes.py on the fusion step's and the CLI's. A
# data-parallel rank's fusion step warps DDP_WARP.
WARP_CHECKS = ((4, 1280, 1280), (SFF_TRAIN_BATCH, SFF_TRAIN_DET, SFF_TRAIN_DET),
               (1, SFF_TRAIN_DET, SFF_TRAIN_DET), (1, 1250, 1250),
               (1, 1280, 1280), (1, 1408, 1280), (1, 320, 256), (4, 640, 640),
               (2, 640, 640), DDP_WARP) + QUALITY_WARPS + ((2, 250, 333),)

# The sepconv forward's signatures (n, c, h, w, k, image dtype, maps dtype)
# and the head tail's (n, hi, wi, cx, k) that the paths launch at full
# width: the SFF restore in bfloat16 (both paths) and float32, 4 sections a
# group, its fused head tails on the 640^2 features; the SP restore, batch
# 2 (the served path's fused head tails); the training step, 32 x 256^2;
# infer_interp_single (one 1280^2 pair) and infer_interp_trainingset (4 x
# 512^2); the interp trainer's validation on phase 10's 320^2 sections;
# micro_bench; the SP trainers (phase 23); the sharded restore's slabs
# (phase 25: 1280^2 data-parallel, 1408 x 1280 with the 256-row halos of
# the 1250^2 dp x sp run, 320 x 256 at its card-vs-CPU size) and the tiled
# restore's 640^2 tiles, 4 a call (2 on each device of a 2-device mesh);
# a data-parallel rank's training step (phase 26: 16 x 256^2); the interp
# and SP training steps under the bf16 compute dtype (phase 28).
# Then the remaining dtype
# pair, K = 5 and 11, and odd sizes and channel counts that take the first
# designs (sepconv W % 4 != 0; head tail Cx % 8 != 0) or the edges of the
# new ones. Phases 3, 11 and 12 hold both designs against the plain version
# at each; phases 6, 10, 14, 18, 19a, 25 and 26 fail on a launched
# signature missing here, and tests/test_torch_conv_shapes.py on a packed
# path's.
SEPCONV_CHECKS = (
    (4, 1, 1280, 1280, K, "bfloat16", "bfloat16"),
    (4, 1, 1280, 1280, K, "float32", "float32"),
    (2, 1, 1280, 1280, K, "bfloat16", "bfloat16"),
    (32, 1, 256, 256, K, "float32", "float32"),
    DDP_INTERP_SIG,
    SP_TRAIN_SIG,
    BF16_TRAIN_SIG,
    BF16_SP_TRAIN_SIG,
    (1, 1, 1280, 1280, K, "float32", "float32"),
    (TRAININGSET_BS, 1, TRAININGSET_SIZE, TRAININGSET_SIZE, K, "float32",
     "float32"),
    (TRAININGSET_BS, 1, TRAININGSET_SIZE, TRAININGSET_SIZE, K, "bfloat16",
     "bfloat16"),
    (1, 1, 320, 320, K, "float32", "float32"),
    (1, 1, 1280, 1280, K, "bfloat16", "bfloat16"),
    (1, 1, 1408, 1280, K, "bfloat16", "bfloat16"),
    (1, 1, 320, 256, K, "float32", "float32"),
    (4, 1, 640, 640, K, "float32", "float32"),
    (2, 1, 640, 640, K, "float32", "float32"),
    *QUALITY_SEPCONV,
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
    (4, 640, 640, 64, K), (2, 640, 640, 64, K),
    (1, 640, 640, 64, K), (1, 704, 640, 64, K),
    (2, 37, 52, 56, K), (1, 9, 4, 64, K), (2, 20, 40, 64, 56),
    (2, 37, 53, K, K), (2, 37, 53, 64, K),
)
# The sepconv backward's signatures, as SEPCONV_CHECKS writes them: the
# interp training step's, the SP trainers' and a data-parallel rank's (the
# three a path launches; phase 11 holds the first, phase 8 the rest), the
# quality tools' and the two training steps' under the bf16 compute dtype
# (phase 28), then
# rows for the simple design (W % 4 != 0), more channels than one block's
# shared memory holds, bf16 maps and image, and C > 1 at odd H on the
# blocked design. Phases 8 and 11 hold both designs against the plain
# version at each; phases 10, 23, 26 and 28 fail on a launched signature
# missing here, and
# tests/test_torch_conv_shapes.py on the training steps'.
SEPCONV_BWD_CHECKS = (
    (32, 1, 256, 256, K, "float32", "float32"),
    SP_TRAIN_SIG,
    DDP_INTERP_SIG,
    *QUALITY_SEPCONV_BWD,
    BF16_TRAIN_SIG,
    BF16_SP_TRAIN_SIG,
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
    the check lists write them. The serving warps of the pipeline, the SFF
    trainers and infer_unfolding go into ``warps``, a Counter of (n, h, w)
    as WARP_CHECKS writes them."""

    def __init__(self):
        import collections

        self.calls = collections.Counter()
        self.maps = collections.Counter()
        self.warps = collections.Counter()

    def __enter__(self):
        from sstem_tpu_torch.cli import infer_unfolding, train_fusion, train_unfolding
        from sstem_tpu_torch.infer import pipeline
        from sstem_tpu_torch.kernels import sepconv, serving_warp
        from sstem_tpu_torch.models import ifnet, serving
        from sstem_tpu_torch.tools import micro_bench

        # the modules that call serving_warp by name
        self._warp_sites = (pipeline, train_fusion, train_unfolding,
                            infer_unfolding)

        def warp_rec(im, flow):
            self.warps[tuple(im.shape[:3])] += 1
            return serving_warp(im, flow)

        for site in self._warp_sites:
            site.serving_warp = warp_rec
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
        from sstem_tpu_torch.kernels import sepconv_planar, serving_warp

        for site in self._warp_sites:
            site.serving_warp = serving_warp
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
    """Every kernel wrapper of the restore and training paths, by name."""
    from sstem_tpu_torch import kernels

    return {"sepconv_fwd": kernels.sepconv_planar,
            "sepconv_bwd": kernels.sepconv_planar_bwd,
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
    SEPCONV_BWD_CHECKS, a warp shape not in WARP_CHECKS."""
    for key, n in sorted(sig.calls.items(), key=str):
        say(f"{label} {key[0]} {key[1]}x{key[2]}x{key[3]} {key[4]}->{key[5]} "
            f"act={key[6]} res={key[7]} launches per {unit}", n / units)
    for key, n in sorted(sig.maps.items(), key=str):
        say(f"{label} {key} launches per {unit}", n / units)
    for key, n in sorted(sig.warps.items()):
        say(f"{label} warp {key} launches per {unit}", n / units)
    missing = ((sig.channels() - checked) | (set(sig.maps) - MAP_CHECKS)
               | (set(sig.warps) - set(WARP_CHECKS)))
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
# spectra meet in a complex pointwise product or complex gemv)
KERNEL_KINDS = (
    ("sepconv", "sepconv kernels"),
    ("conv3x3_fused", "conv3x3 kernel"), ("conv3x3_wgmma", "conv3x3 kernel"),
    ("deconv2x_fused", "deconv kernel"), ("deconv2x_wgmma", "deconv kernel"),
    ("pool2x_kernel", "pool kernel"), ("head_tail", "head-tail kernel"),
    ("warp_bilinear", "warp kernel"),
    ("multi_tensor_apply", "optimizer"),
    ("conv", "convolution"), ("gemm", "convolution"), ("fft", "convolution"),
    ("gemv", "convolution"),
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


def profile_steps(train_step, state, batch, steps=2, label="train"):
    """torch.profiler over ``steps`` training steps (``profile_runs``)."""
    box = [state]

    def step():
        box[0], _ = train_step(box[0], batch)

    profile_runs(label, step, steps, 1, "step", f"{label}_profile.json")


def device_events(prof, trace_name):
    """The device's work (kernels, copies, memsets) in a finished
    torch.profiler run, from its trace exported under ``OUT``; may be
    empty."""
    os.makedirs(OUT, exist_ok=True)
    trace = os.path.join(OUT, trace_name)
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X" and e.get("cat") in DEVICE_WORK]


def device_work(prof, trace_name):
    """``device_events``, failing when the trace holds none."""
    work = device_events(prof, trace_name)
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
    model, opt, train_step, _, _, _ = train_interp.build(cfg, "cuda", seed=SEED)
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
    ("probe_copy", "copy kernel"), ("probe_gather", "gather kernel"), ("probe_roll", "roll kernel"),
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


def device_us(fn, trace_name, reps=200, warmup=5, tries=3):
    """Device microseconds per call of ``fn`` by kind (``PROBE_KINDS``),
    from torch.profiler over ``reps`` calls: {kind: us per call}.

    These sessions last a few milliseconds, and late in a full run the
    trace of one has come back without a single device event while the
    calls ran on the card (the profiler dropped them, in about half of the
    runs through phase 19). A trace without device work is profiled
    again, up to ``tries`` sessions in all, each retry printed; the last
    must hold device work."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        work = device_events(prof, trace_name)
        if work:
            break
        say(f"device_us {trace_name}: session {attempt} of {tries} held no "
            "device work", "profiled again" if attempt < tries else "failing")
    assert work, "the trace holds no device work"
    kinds = {}
    for e in work:
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
    for key in ("design", "entry", "ms", "mma_ms", "simple_ms", "plain_ms",
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


# the source of each conv3x3 design (csrc/conv3x3_fused.cu but narrow_in)
CONV_SOURCES = {"narrow_in": "sstem_tpu_torch/csrc/conv3x3_narrow_in.cu"}


def time_conv_rows(rows, gen, calls, units):
    """conv3x3 at each (n, h, w, cin, cout, residual), by CUDA events: the
    design the C entry point picks (ms) and the mma.sync design (its _mma
    entry point, mma_ms) in alternating rounds, the plain version, the
    bare cuDNN conv (bf16 channels-last, library_ms), cuDNN with the
    epilogue as separate ops, the bound, and the launches per unit of the
    recorded path run; with the design's entry point and source."""
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
        ms, mma_ms = paired_ms(entry("sstem_conv3x3_fused"),
                               entry(c3.ENTRY_POINTS["mma"]), 5, 10)
        t = timing(
            ms,
            cuda_ms(lambda: c3.conv3x3_fused_plain(x, wt, scale, shift,
                                                   "relu", r, pre), 2),
            cuda_ms(lambda: F.conv2d(x_cl, w_cl, padding=1), 10, 2),
            roofline(nbytes, 2 * n * h * w * 9 * cin * cout, BF16_FLOP_PER_S))
        design = c3.design(cin, cout)
        t.update(design=design, entry=c3.ENTRY_POINTS[design],
                 source=CONV_SOURCES.get(
                     design, "sstem_tpu_torch/csrc/conv3x3_fused.cu"),
                 mma_ms=mma_ms,
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
    out[f"head_tail[K{K}@4x640^2]"] = time_head_tail(4, gen, maps, units)
    for name in ("pool2x[max]", "pool2x[avg]", f"head_tail[K{K}@4x640^2]"):
        say_timing(name, out[name])
    return out


def time_head_tail(n, gen, maps, units, hi=640, wi=640):
    """The head tail at (n, hi, wi, 64 channels, K) by CUDA events, with
    both designs, beside its plain version, the upsample and conv as
    PyTorch calls and its bound; its launches per unit from the recorded
    ``maps`` of a path run over ``units`` units."""
    import torch.nn.functional as F

    ht = head_tail_module()
    x, w3, b3 = head_tail_inputs(n, hi, wi, 64, K, gen)
    w3_oihw = w3.permute(3, 2, 0, 1).contiguous()
    b3_bf = b3.to(torch.bfloat16)

    def library():
        up = F.interpolate(x[..., :K].permute(0, 3, 1, 2).contiguous(),
                           scale_factor=2, mode="bilinear", align_corners=True)
        return F.conv2d(up, w3_oihw, b3_bf, padding=1)

    nbytes = 2 * (n * hi * wi * 64 + 9 * K * K + n * K * 4 * hi * wi) + 4 * K
    flop = 2 * n * 4 * hi * wi * K * K * 9
    t = timing(
        cuda_ms(lambda: ht.launch_entry("sstem_head_tail", x, w3, b3), 10, 2),
        cuda_ms(lambda: ht.head_tail_plain(x, w3, b3), 3),
        cuda_ms(library, 10, 2), roofline(nbytes, flop, BF16_FLOP_PER_S))
    t.update(design=ht.design(wi, 64, K),
             mma_ms=cuda_ms(lambda: ht.launch_entry(ht.ENTRY_POINTS["mma"], x,
                                                    w3, b3), 10, 2),
             launches_per_unit=maps[("head_tail", n, hi, wi, 64, K)] / units)
    return t


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


def sp_models(seed=SEED, kernel_size=K):
    """Copies of the SP models on seeded random weights: IFNet(K,
    n_frames=2) with each kernel head's last conv rescaled as
    ``build_pipeline`` does, UNetSP and FusionNetSP by ``he_init_`` with the
    1x1 output conv scaled by 0.1 and its bias set for a mean output of 0.5,
    so that the outputs are not clipped flat. The models are made once per
    seed (the orthogonal init takes seconds)."""
    import copy

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
    return copy.deepcopy(_SP_MODELS[key])


class ServedSP:
    """``bench_sp.py:117-135``'s quartet restore on the serving forwards
    alone, bf16 on the port's kernels: ``ifnet_serve(n_frames=2)`` on the
    2-channel pair (clipped), ``unet_sp_serve`` on each degraded section
    and ``fusionnet_sp_serve`` on the mask blends. The JAX ``SPPipeline``
    serves its interp as a module, so this composition stays here.
    ``restore`` takes and returns what ``SPPipeline.restore`` does."""

    def __init__(self, vfi, denoise, fusion, device, fused_head_tail=False):
        self.device = torch.device(device)
        self.vfi, self.denoise, self.fusion = (
            m.to(self.device).eval() for m in (vfi, denoise, fusion))
        self.fused_head_tail = fused_head_tail

    def _to01(self, img):
        return torch.as_tensor(img, device=self.device).float() / 255.0

    @torch.inference_mode()
    def restore(self, img1, img4, deg2, deg3, mask2, mask3):
        from sstem_tpu_torch.infer.tiles import pad_to_multiple
        from sstem_tpu_torch.models.serving import (
            fusionnet_sp_serve, ifnet_serve, unet_sp_serve)

        x, (h, w) = pad_to_multiple(
            torch.stack([self._to01(img1), self._to01(img4)], -1), 32)
        vfi = ifnet_serve(self.vfi, x, n_frames=2,
                          fused_head_tail=self.fused_head_tail).clamp(0.0, 1.0)
        d2, d3, m2, m3 = (pad_to_multiple(self._to01(t)[..., None], 32)[0]
                          for t in (deg2, deg3, mask2, mask3))
        den2 = unet_sp_serve(self.denoise, d2)
        den3 = unet_sp_serve(self.denoise, d3)
        p1 = fusionnet_sp_serve(self.fusion, vfi[..., 0:1] * (1 - m2), den2 * m2)
        p2 = fusionnet_sp_serve(self.fusion, vfi[..., 1:2] * (1 - m3), den3 * m3)

        def crop(t):
            return t[:, :h, :w, 0].clamp(0.0, 1.0)

        return {"pred1": crop(p1), "pred2": crop(p2),
                "vfi1": vfi[:, :h, :w, 0], "vfi2": vfi[:, :h, :w, 1],
                "denoise1": crop(den2), "denoise2": crop(den3)}


def build_sp_pipeline(device, dtype, seed=SEED, kernel_size=K,
                      packed_conv=False):
    """SPPipeline on ``sp_models``' weights."""
    from sstem_tpu_torch.infer.pipeline import SPPipeline

    return SPPipeline(*sp_models(seed, kernel_size), device=device,
                      dtype=dtype, packed_conv=packed_conv)


# the SP paths: SPPipeline on cuDNN and on the packed U-Nets (its interp a
# module on both), and the served composition with the head tails on cuDNN
# and on the head-tail kernel
SP_PATHS = ("cudnn", "packed", "served", "served_fused_tail")


def build_sp_path(path, device):
    """One of ``SP_PATHS`` in bf16 on ``sp_models``' weights."""
    from sstem_tpu_torch import config

    if path.startswith("served"):
        return ServedSP(*sp_models(), device,
                        fused_head_tail=path == "served_fused_tail")
    return build_sp_pipeline(device, config.SERVING_DTYPE,
                             packed_conv=path == "packed")


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
    """Phase 17: the SP restore on the card against the CPU on two quartets
    of a 150 x 170 stack: SPPipeline in float32 (TF32 off, 1e-3 abs), and
    the packed path and the served composition (head tails on cuDNN and on
    the kernel) in bf16 on both sides (NRMSE below SP_PACKED_NRMSE of each
    output's std)."""
    from sstem_tpu_torch import config
    from sstem_tpu_torch.data import synth_stack

    stack = torch.from_numpy(synth_stack(8, 150, 170, seed=SEED))
    rng = np.random.default_rng(SEED)
    masks = torch.from_numpy(np.stack(
        [np.full((150, 170), 128, np.uint8)] * 8))
    masks[2::4] = torch.from_numpy(
        (rng.random((2, 150, 170)) > 0.8).astype(np.uint8) * 255)
    args = quartets(stack, masks, [0, 4])
    for path in ("float32",) + SP_PATHS[1:]:
        label = f"sp card-vs-cpu {path}"
        packed = path != "float32"

        def build(dev):
            if packed:
                return build_sp_path(path, dev)
            return build_sp_pipeline(dev, config.PARITY_DTYPE)

        outs = [build(dev).restore(*(a.to(dev) for a in args))
                for dev in (DEV, "cpu")]
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
# models/ifnet.py): the two-frame IFNet makes 2 sepconvs per frame on every
# path; on the packed and served paths each of the 4 U-Net forwards
# (denoise x2, fusion x2) makes 11 conv3x3 launches (inc 2, down1 2, up3
# and up4 a split concat conv of 2 plus conv1, outc 1) and 1 pool (before
# down1); the served IFNet adds 31 conv3x3 launches (conv32 3, conv64 3,
# upsamp64 1, 8 heads x 3) and 1 avg pool, and, with fused tails, 8 head
# tails
SP_LAUNCHES = {"cudnn": {"sepconv_fwd": 4},
               "packed": {"sepconv_fwd": 4, "conv3x3_fused": 44, "pool2x": 4},
               "served": {"sepconv_fwd": 4, "conv3x3_fused": 75, "pool2x": 5},
               "served_fused_tail": {"sepconv_fwd": 4, "conv3x3_fused": 75,
                                     "pool2x": 5, "head_tail": 8}}
SP_QUARTETS, SP_BATCH, SP_SIZE = 6, 2, 1250


def sp_full_width(path, stack, masks):
    """Phase 18 on one of ``SP_PATHS``: the workload bench_sp.py:40-122
    defines (6 quartets of 1250^2, batch 2, K=51, bf16). Returns (launch
    counts of one run, ms per quartet, the KernelSignatures of that run,
    batches)."""
    wrappers = counted_kernels()
    pipe = build_sp_path(path, "cuda")
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


def check_copy(gen):
    """The tile copy bit-exact against its plain version at the probe's
    shapes and at ``tools/probe_dma_conv.py: COPY_EDGE_CASES``."""
    from sstem_tpu_torch.kernels import tile_copy, tile_copy_plain
    from sstem_tpu_torch.tools import probe_dma_conv

    cases = [(name, shape, "bfloat16", probe_dma_conv.COPY_TY)
             for name, shape in probe_dma_conv.COPY_SHAPES]
    for name, shape, dtype, ty in cases + list(probe_dma_conv.COPY_EDGE_CASES):
        dt = getattr(torch, dtype)
        if dt.is_floating_point:
            x = randn(shape, gen, dtype=dt)
        else:
            x = torch.randint(-128 if dt == torch.int8 else 0,
                              128 if dt == torch.int8 else 256, shape,
                              generator=gen, device=DEV, dtype=dt)
        check_exact(f"probe_copy {tuple(shape)} {dtype} ty={ty} "
                    f"({' '.join(name.split()[:2])})",
                    tile_copy(x, ty), tile_copy_plain(x, ty))


def check_probe_kernels(gen):
    """Phase 16: the probe kernels (exact) and conv3x3_fused at every SP
    path signature (1 bf16 ulp + 2^-14 of the max) against their plain
    versions, at the SP path's and the probes' shapes, at odd sizes and,
    for the gather and the roll, at every EDGE_CASES row."""
    from sstem_tpu_torch.kernels import (
        roll_dynamic, roll_dynamic_plain, take_along_axis,
        take_along_axis_plain)
    from sstem_tpu_torch.tools import probe_gather

    err = {"pool2x": check_pool(2, 1280, 1280, 64, "max", gen),
           "conv3x3_fused": max(check_conv(*c, gen) for c in SP_CONV_CHECKS)}
    check_copy(gen)
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
        take_along_axis, take_along_axis_plain)
    from sstem_tpu_torch.kernels import _build
    from sstem_tpu_torch.kernels import sepconv as sc
    from sstem_tpu_torch.ops import replication_pad_2d
    from sstem_tpu_torch.tools import probe_dma_conv, probe_gather

    out = time_copy(gen)
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


def time_copy(gen):
    """Phase 19b's tile copy at the probe's shapes: the kernel and
    ``Tensor.copy_`` into a preallocated output in alternating rounds
    (``paired_ms``; the wrapper allocates its output in each call, which
    the caching allocator serves on the host while the device copies), the
    plain version, the bound, the achieved rate and share of the bound, and
    the host and device microseconds per call of both
    (``host_device_split``). Returns {name: timing dict}."""
    from sstem_tpu_torch.kernels import tile_copy, tile_copy_plain
    from sstem_tpu_torch.tools import probe_dma_conv

    out = {}
    ty = probe_dma_conv.COPY_TY
    for _, shape in probe_dma_conv.COPY_SHAPES:
        x = randn(shape, gen)
        y = torch.empty_like(x)
        nbytes = 2 * x.numel() * x.element_size()
        name = f"probe_copy[{'x'.join(map(str, shape))} bf16]"
        kernel = lambda: tile_copy(x, ty)
        library = lambda: y.copy_(x)
        ms, library_ms = paired_ms(kernel, library, rounds=5, reps=50)
        t = out[name] = timing(ms, cuda_ms(lambda: tile_copy_plain(x), 20, 3),
                               library_ms, roofline(nbytes, 0, BF16_FLOP_PER_S))
        say(f"{name} GB/s (read + write)", nbytes / ms / 1e6)
        say(f"{name} share of bound", t["bound_ms"] / ms)
        say(f"{name} copy_ share of bound", t["bound_ms"] / library_ms)
        t.update(host_device_split(name, kernel, library))
        del x, y
    return out


def time_sp_kernels(gen, sig, batches):
    """Phase 18b: conv3x3 at every full-width shape of the SP served path
    (time_conv_rows; ``sig``: the served path's recorded signatures, fused
    head tails, over ``batches`` batches), the SP pool beside its plain
    version, F.max_pool2d and its bound, the SP sepconv with both designs
    and the SP head tail with both (``time_head_tail``)."""
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
    name = f"head_tail[K{K}@{SP_BATCH}x640^2]"
    out[name] = time_head_tail(SP_BATCH, gen, sig.maps, batches)
    say_timing(name, out[name])
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
    runs = {path: sp_full_width(path, stack, masks) for path in SP_PATHS}
    for path, (_, ms, _, _) in runs.items():
        say(f"sp full bfloat16 {path} ms_per_quartet, this phase", ms)
        if path != "cudnn":
            say(f"sp full {path} speedup over cudnn", runs["cudnn"][1] / ms)
    res["sp_launches"] = runs["served_fused_tail"][0]
    del stack, masks
    torch.cuda.empty_cache()
    _, _, sig, batches = runs["served_fused_tail"]
    res["sp_times"] = time_sp_kernels(gen, sig, batches)

    phase("19 the probes at their JAX shapes (CUDA events)")
    res["probe_launches"] = run_probes()
    res["probe_times"] = time_probe_kernels(gen, res["err"])
    return res


# ---------------------------------------------------------------------------
# phase 20: the SFF inference CLIs
# ---------------------------------------------------------------------------

CLI_SIZE, CLI_SECTIONS, CLI_IDS = 1250, 9, (1, 3, 5, 7)


def write_cli_case(root):
    """The SFF CLIs' inputs under ``root``: a synth_stack of CLI_SECTIONS
    sections of CLI_SIZE^2 as %04d.png in data/sff, data/sff.txt with
    CLI_IDS, a config (TRAIN.kernel_size K, TRAIN.ngf 32, TEST.pad 0) and
    build_pipeline's seeded IFNet(K), FusionNet and UNetSFF as reference
    checkpoints (``model_weights`` with ``module.`` prefixes). Returns the
    arguments both CLIs share, without -op."""
    from PIL import Image

    from sstem_tpu_torch import config
    from sstem_tpu_torch.data import synth_stack

    data = os.path.join(root, "data", "sff")
    os.makedirs(data)
    for i, img in enumerate(synth_stack(CLI_SECTIONS, CLI_SIZE, CLI_SIZE,
                                       seed=SEED)):
        Image.fromarray(img).save(os.path.join(data, f"{i:04d}.png"))
    with open(os.path.join(root, "data", "sff.txt"), "w") as f:
        f.write(" ".join(map(str, CLI_IDS)))
    cfg = os.path.join(root, "cfg.yaml")
    with open(cfg, "w") as f:
        f.write(f"TRAIN:\n  kernel_size: {K}\n  ngf: 32\nTEST:\n  pad: 0\n")
    pipe = build_pipeline("cpu", config.PARITY_DTYPE)
    for name in ("interp", "flow", "fusion"):
        model = getattr(pipe, f"{name}_model")
        torch.save({"model_weights": {f"module.{k}": v for k, v in
                                      model.state_dict().items()}},
                   os.path.join(root, f"{name}.pth"))
    return ["-c", cfg, "-ip", os.path.join(root, "data"), "-t", "sff",
            "-m", "valid"]


def run_cli(label, main, argv, want):
    """One CLI ``main(argv)`` on the card with every restore kernel's count
    set to 0 just before: asserts the launches ``want`` ({kernel: count},
    the others 0), echoes the CLI's output and returns it."""
    import contextlib
    import io

    wrappers = counted_kernels()
    for fn in wrappers.values():
        fn.launches = 0
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        main(argv)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    print(text.getvalue(), end="", flush=True)
    for k, n in launches.items():
        if n:
            say(f"{label} {k} launches", n)
    assert launches == {k: want.get(k, 0) for k in wrappers}, (label, launches)
    return text.getvalue()


def sff_cli_phase():
    """Phase 20: ``infer_interp.main`` then ``infer_fusion.main`` (through
    their argv) on the card at CLI_SIZE^2, one section a call, on the
    default float32 path and with ``--packed-conv`` (bf16, fused-conv
    serving forwards), each configuration twice (the first run of a
    process pays cuDNN's and the kernels' first calls): sepconv 2 and warp
    1 launches per section asserted (conv3x3, pool and deconv on the packed
    path by the per-net counts of PATH_LAUNCHES), every PNG's shape, and the
    average inference time per section that infer_fusion prints."""
    import re

    from PIL import Image

    from sstem_tpu_torch.cli import infer_fusion, infer_interp

    root = os.path.join(OUT, "sff_cli")
    shutil.rmtree(root, ignore_errors=True)
    common = write_cli_case(root)
    n = len(CLI_IDS)
    # per section: IFNet conv3x3 19 and a pool; FusionNet and UNetSFF
    # conv3x3 31, 2 pools and 4 deconvs (PATH_LAUNCHES["packed"] less IFNet)
    packed_interp = {"conv3x3_fused": 19 * n, "pool2x": n}
    packed_fusion = {"conv3x3_fused": 31 * n, "pool2x": 2 * n,
                     "deconv2x_fused": 4 * n}
    for label, flags in (("float32", []), ("packed bf16", ["--packed-conv"])):
        for run in (1, 2):
            out = os.path.join(root, f"out_{'packed' if flags else 'f32'}")
            name = f"sff cli {label} run {run}"
            run_cli(f"{name} infer_interp", infer_interp.main,
                    common + ["-op", out, "--ckpt",
                              os.path.join(root, "interp.pth"), *flags],
                    {"sepconv_fwd": 2 * n, **(packed_interp if flags else {})})
            text = run_cli(
                f"{name} infer_fusion", infer_fusion.main,
                common + ["-op", out, "--ckpt", os.path.join(root, "fusion.pth"),
                          "--flow-ckpt", os.path.join(root, "flow.pth"),
                          *flags],
                {"warp_bilinear": n, **(packed_fusion if flags else {})})
            for folder, shape in (("sff_interp", (CLI_SIZE, CLI_SIZE)),
                                  ("sff_fusion", (CLI_SIZE, CLI_SIZE)),
                                  ("sff_fusion_stitching", (CLI_SIZE, CLI_SIZE)),
                                  ("sff_fusion_flow", (CLI_SIZE, CLI_SIZE, 3))):
                for i in CLI_IDS:
                    img = np.asarray(Image.open(
                        os.path.join(out, folder, f"{i:04d}.png")))
                    assert img.dtype == np.uint8 and img.shape == shape, (
                        folder, i, img.shape)
            avg = float(re.search(r"average inference time: (\S+)",
                                  text).group(1))
            say(f"{name} infer_fusion average inference time ms per section "
                f"({CLI_SIZE}^2, batch 1)", avg * 1e3)


# ---------------------------------------------------------------------------
# phases 21-22: SFF correction and fusion training, and the last SFF CLIs
# ---------------------------------------------------------------------------

def write_sff_train_config(root, data, name, train):
    """A correction or fusion trainer's config at bench.py:394-399's
    workload (FusionNet ngf 32, batch SFF_TRAIN_BATCH of SFF_TRAIN_CROP^2
    crops to SFF_TRAIN_DET^2, L1, AdamW wd 1e-4 under the poly warmup/decay
    LR, the reference's augmentations) as a reference-style YAML config, as
    write_interp_config writes one; ``train`` adds TRAIN keys."""
    import yaml

    aug = {"random_fliplr": True, "random_flipud": True, "random_flipz": True,
           "random_rotation": True, "swap": False, "color_jitter": False,
           "COLOR": {"brightness": 0.2, "contrast": 0.2, "saturation": 0.2},
           "elastic_trans": False,
           "ELASTIC": {"alpha_range": 100, "sigma": 10, "shave": 20},
           "gauss_noise": False, "GAUSS": {"gauss_mean": 0, "gauss_sigma": 0.001}}
    cfg = {"NAME": name,
           "TRAIN": {"resume": False, "if_valid": False,
                     "cache_path": os.path.join(root, "caches"),
                     "save_path": os.path.join(root, "models"),
                     "input_nc": 6, "output_nc": 2, "ngf": 32, "loss": "L1",
                     "kernel_size": K, "total_iters": 400000,
                     "warmup_iters": 1000, "base_lr": 1e-4, "end_lr": 1e-6,
                     "decay_iters": 400000, "power": 1.5, "weight_decay": 1e-4,
                     "display_freq": 100, "valid_freq": 1000, "save_freq": 1000,
                     "batch_size": SFF_TRAIN_BATCH, "random_seed": SEED,
                     **train},
           "DATA": {"folder_name": data, "train_txt": "train_data.txt",
                    "interp_train_txt": "interp_train_data.txt",
                    "patch_size": [SFF_TRAIN_CROP, SFF_TRAIN_CROP],
                    "det_size": SFF_TRAIN_DET, "AUG": aug},
           "TEST": {"pad": 0}}
    path = os.path.join(root, name + ".yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def run_main(label, main, argv, want):
    """``run_cli`` under KernelSignatures: the launches asserted, and every
    sepconv and warp signature the run launched checked against the lists.
    Returns (the CLI's output, the signatures)."""
    with KernelSignatures() as sig:
        text = run_cli(label, main, argv, want)
    report_signatures(label, sig, 1, "run")
    return text, sig


def time_train_step(label, step, state, next_batch, timed=10, warm=3,
                    pixels=SFF_TRAIN_BATCH * SFF_TRAIN_DET ** 2):
    """The step's ms (median of ``timed`` after ``warm``), steps/s, MP/s of
    its ``pixels`` output pixels (by default SFF_TRAIN_BATCH x
    SFF_TRAIN_DET^2), peak memory and the kernels' launches per step, each
    step's input from ``next_batch()`` (a provider's next batch, whose wait
    for the host counts, or the pool step's counter); then 2 steps under
    torch.profiler. Returns (ms, launches per step by kernel)."""
    wrappers = counted_kernels()
    box = [state]

    def run():
        box[0], metrics = step(box[0], next_batch())
        return metrics

    for _ in range(warm):
        run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    times = []
    with KernelSignatures() as sig:
        for _ in range(timed):
            t0 = time.perf_counter()
            metrics = run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    report_signatures(f"{label} step", sig, timed, "step")
    per_step = {k: fn.launches / timed for k, fn in wrappers.items()
                if fn.launches}
    loss = float(metrics["loss"])
    assert np.isfinite(loss), (label, loss)
    ms = statistics.median(times) * 1e3
    say(f"{label} step loss after {warm + timed} steps", loss)
    say(f"{label} step ms (median of {timed} after {warm} warm)", ms)
    say(f"{label} step ms runs", [t * 1e3 for t in times])
    say(f"{label} step steps_per_s", 1e3 / ms)
    say(f"{label} step MP_per_s", pixels / ms / 1e3)
    say(f"{label} step peak_memory_GiB",
        torch.cuda.max_memory_allocated() / 2 ** 30)
    for k, n in sorted(per_step.items()):
        say(f"{label} step {k} launches per step", n)
    profile_runs(f"{label} step", run, 2, 1, "step",
                 f"{label.replace(' ', '_')}_profile.json")
    return ms, per_step


def sff_training_phase(interp_ckpt):
    """Phase 21: the SFF training chain at full width on a seeded triplet
    tree of TRAININGSET_ROWS x TRAININGSET_SIZE^2: infer_interp_trainingset
    (-bs TRAININGSET_BS) writes the interp images; train_interp
    --device-datagen runs 3 steps of phase 10's workload; train_unfolding
    and train_fusion (behind the unfolding run's checkpoint) run 3 steps
    each on the host and the device datagen paths, and the fusion run is
    resumed with --resume-from; each run's launches are asserted and its
    signatures checked. Then the steps of each ``build(cfg)`` are timed at
    bench.py:394-399's workload on both datagen paths (device: the pool on
    the card). Returns the new paths' launches for the JSON line."""
    from sstem_tpu_torch.cli import (
        infer_interp_trainingset, train_fusion, train_interp, train_unfolding,
    )
    from sstem_tpu_torch.compat.config import load_sff_config
    from sstem_tpu_torch.data import write_triplet_tree
    from sstem_tpu_torch.data.providers import (
        FusionTrainDataset, Provider, RawCropPairDataset, UnfoldingTrainDataset,
    )
    from sstem_tpu_torch.train import device_datagen
    from sstem_tpu_torch.train.trainer import TrainState

    root = os.path.join(OUT, "sff_train")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "data")
    write_triplet_tree(data, n_triplets=TRAININGSET_ROWS, size=TRAININGSET_SIZE,
                       seed=SEED)
    cfg_i = os.path.join(root, "interp.yaml")
    with open(cfg_i, "w") as f:
        f.write(f"TRAIN:\n  kernel_size: {K}\nTEST:\n  pad: 0\n"
                f"DATA:\n  folder_name: {data}\n  train_txt: train_data.txt\n")
    launches = {}
    batches = -(-TRAININGSET_ROWS // TRAININGSET_BS)
    _, sig = run_main("sff train infer_interp_trainingset",
                      infer_interp_trainingset.main,
                      ["-c", cfg_i, "--ckpt", interp_ckpt,
                       "-bs", str(TRAININGSET_BS)],
                      {"sepconv_fwd": 2 * batches})
    assert set(sig.maps) == {("sepconv", TRAININGSET_BS, 1, TRAININGSET_SIZE,
                              TRAININGSET_SIZE, K, "float32", "float32")}, sig.maps
    launches["trainingset"] = 2 * batches
    with open(os.path.join(data, "interp_train_data.txt")) as f:
        assert len(f.read().split()) == TRAININGSET_ROWS

    # train_interp --device-datagen: phase 10's config; 2 sepconvs forward
    # and backward a step, and 2 forward for each of the two validation
    # images at step 1 (no preview on this path)
    steps = 3
    text, _ = run_main(
        "sff train train_interp --device-datagen", train_interp.main,
        ["-c", os.path.join(OUT, "interp_k51_b32.yaml"), "--max-iters",
         str(steps), "--device-datagen"],
        {"sepconv_fwd": 2 * steps + 2 * 2, "sepconv_bwd": 2 * steps})
    assert "pool on the card" in text, text[-2000:]
    launches["interp_devgen"] = {"sepconv_fwd": 2 * steps + 4,
                                 "sepconv_bwd": 2 * steps}

    for dg in ("host", "device"):
        flags = ["--device-datagen"] if dg == "device" else []
        cfg_u = write_sff_train_config(root, data, f"unfold_{dg}", {})
        # the host path's step-1 preview warps once
        run_main(f"sff train train_unfolding {dg}", train_unfolding.main,
                 ["-c", cfg_u, "--max-iters", str(steps)] + flags,
                 {"warp_bilinear": 1 if dg == "host" else 0})
    save_u = os.path.join(root, "models")
    flow_dir = sorted(d for d in os.listdir(save_u) if d.endswith("unfold_device"))
    flow_dir = os.path.join(save_u, flow_dir[-1])
    assert os.path.exists(os.path.join(flow_dir, "model-%06d.ckpt" % steps))
    fusion = {"output_nc": 1, "flownet_path": flow_dir,
              "flownet_id": "model-%06d.ckpt" % steps}
    fusion_warps = {}
    for dg in ("host", "device"):
        flags = ["--device-datagen"] if dg == "device" else []
        cfg_f = write_sff_train_config(root, data, f"fusion_{dg}", fusion)
        # a warp a step, and one for the host path's step-1 preview
        want = steps + (1 if dg == "host" else 0)
        _, sig = run_main(f"sff train train_fusion {dg}", train_fusion.main,
                          ["-c", cfg_f, "--max-iters", str(steps)] + flags,
                          {"warp_bilinear": want})
        assert set(sig.warps) == {(SFF_TRAIN_BATCH, SFF_TRAIN_DET,
                                   SFF_TRAIN_DET)} | (
            {(1, SFF_TRAIN_DET, SFF_TRAIN_DET)} if dg == "host" else set()), sig.warps
        fusion_warps[dg] = want
    fusion_save = sorted(d for d in os.listdir(save_u)
                         if d.endswith("fusion_device"))[-1]
    cfg_r = write_sff_train_config(root, data, "fusion_resumed", fusion)
    run_main("sff train train_fusion --resume-from", train_fusion.main,
             ["-c", cfg_r, "--max-iters", str(steps + 2), "--device-datagen",
              "--resume-from", os.path.join(save_u, fusion_save)],
             {"warp_bilinear": 2})
    resumed = sorted(d for d in os.listdir(save_u)
                     if d.endswith("fusion_resumed"))[-1]
    payload = torch.load(os.path.join(save_u, resumed,
                                      "model-%06d.ckpt" % (steps + 2)),
                         map_location="cpu", weights_only=True)
    opt_steps = {int(v["step"]) for v in payload["optimizer_weights"]["state"].values()}
    say("sff train fusion resumed optimizer steps", sorted(opt_steps))
    assert opt_steps == {steps + 2}, opt_steps
    launches["fusion_main"] = sum(fusion_warps.values()) + 2

    # the steps of build(cfg) at the workload
    torch.cuda.empty_cache()
    seed = SEED
    cfg_u = load_sff_config(write_sff_train_config(root, data, "unfold_t", {}))
    cfg_f = load_sff_config(write_sff_train_config(root, data, "fusion_t",
                                                   fusion))
    pairs = RawCropPairDataset(data, "train_data.txt", "interp_train_data.txt",
                               crop_size=SFF_TRAIN_CROP)
    pool = pairs.load_pool()
    assert pool is not None and pool.shape == (TRAININGSET_ROWS, 2,
                                               TRAININGSET_SIZE,
                                               TRAININGSET_SIZE), pool
    flow_model = train_fusion.load_flow_model(
        os.path.join(flow_dir, "model-%06d.ckpt" % steps), 32, "cuda")
    ms = {}
    for name, cfg in (("unfolding", cfg_u), ("fusion", cfg_f)):
        for dg in ("device", "host"):
            if name == "unfolding":
                model, opt, step, _, _ = train_unfolding.build(cfg, "cuda", seed)
                base = device_datagen.make_device_datagen_loss(
                    det_size=SFF_TRAIN_DET, seed=seed)
                ds = UnfoldingTrainDataset(
                    data, "train_data.txt", "interp_train_data.txt",
                    crop_size=SFF_TRAIN_CROP, det_size=SFF_TRAIN_DET)
            else:
                model, opt, step, _, _ = train_fusion.build(cfg, flow_model,
                                                            "cuda", seed)
                base = train_fusion.make_fusion_devgen_loss(
                    flow_model, SFF_TRAIN_DET, seed)
                ds = FusionTrainDataset(
                    data, "train_data.txt", "interp_train_data.txt",
                    crop_size=SFF_TRAIN_CROP, det_size=SFF_TRAIN_DET)
            label = f"sff train {name} {dg} datagen"
            state = TrainState(model, opt)
            if dg == "device":
                step = device_datagen.make_pool_step(
                    base, pool, SFF_TRAIN_BATCH, SFF_TRAIN_CROP, "cuda",
                    seed=seed)
                provider = device_datagen.CounterProvider()
            else:
                provider = Provider(ds, SFF_TRAIN_BATCH, seed=seed,
                                    device="cuda")
            try:
                ms[name, dg], per = time_train_step(label, step, state,
                                                    provider.next)
            finally:
                provider.close()
            want = 1 if name == "fusion" else 0
            assert per.get("warp_bilinear", 0) == want, (label, per)
            del model, opt, state
            torch.cuda.empty_cache()
    for name in ("unfolding", "fusion"):
        say(f"sff train {name} ms_per_step host datagen vs device datagen",
            [ms[name, "host"], ms[name, "device"]])
    return launches


def write_unfolding_case(root, case_root, n_sections):
    """infer_unfolding's inputs from phase 20's stack: each damaged section
    folded on the host (sim_sff.degrade_sff's fold synthesis and uint8 warp,
    at the full CLI_SIZE^2, line width 5..20, from the seed) as
    %04d.png under data/sff. Returns the ground-truth unfolding flows by
    id."""
    from PIL import Image

    from sstem_tpu_torch.data import sim_sff
    from sstem_tpu_torch.ops.flow import gen_flow_np

    rng = np.random.default_rng(SEED)
    src = os.path.join(case_root, "data", "sff")
    data = os.path.join(root, "data", "sff")
    os.makedirs(data)
    shutil.copy(os.path.join(case_root, "data", "sff.txt"),
                os.path.join(root, "data", "sff.txt"))
    flows = {}
    for i in range(n_sections):
        img = np.asarray(Image.open(os.path.join(src, f"{i:04d}.png")))
        if i in CLI_IDS:
            p = sim_sff.sample_fold_params(rng, *img.shape, (5, 20))
            flow, flow2, mask = gen_flow_np(*img.shape, p["k"], p["b"],
                                            p["line_width"], p["fold_width"],
                                            p["dis_k"])
            img = (sim_sff._np_image_warp_bilinear(img, flow) * mask).astype(
                np.uint8)
            flows[i] = flow2
        Image.fromarray(img).save(os.path.join(data, f"{i:04d}.png"))
    return flows


def sff_serving_cli_phase():
    """Phase 22: infer_unfolding (float32, TF32 off, test mode: valid mode
    reads HDF5, which the card's machine lacks) on phase 20's stack with its
    damaged sections folded from the seed, and infer_interp_single on one
    CLI_SIZE^2 pair, each twice: warp 1 a section and sepconv 2 a pair
    asserted, the signatures checked, the output shapes, the average flow
    and warp ms a section; then the EPE of the flow net's flow against the
    synthesized unfolding flow (a sanity bound: finite, random weights).
    Returns the two runs' launches for the JSON line."""
    import re

    from PIL import Image

    from sstem_tpu_torch import losses
    from sstem_tpu_torch.cli import infer_interp_single, infer_unfolding
    from sstem_tpu_torch.cli._ckpt import load_model
    from sstem_tpu_torch.models import FusionNet

    case = os.path.join(OUT, "sff_cli")
    root = os.path.join(OUT, "sff_cli_unfolding")
    shutil.rmtree(root, ignore_errors=True)
    flows = write_unfolding_case(root, case, CLI_SECTIONS)
    n = len(CLI_IDS)
    out = os.path.join(root, "out")
    argv = ["-c", os.path.join(case, "cfg.yaml"), "-ip",
            os.path.join(root, "data"), "-t", "sff", "-op", out, "-m", "test",
            "--ckpt", os.path.join(case, "flow.pth"), "--interp-dir",
            os.path.join(case, "out_f32", "sff_interp")]
    for run in (1, 2):
        text, _ = run_main(f"sff cli infer_unfolding run {run}",
                           infer_unfolding.main, argv, {"warp_bilinear": n})
        for folder, shape in (("sff_unfolding_fusionnet", (CLI_SIZE, CLI_SIZE)),
                              ("sff_unfolding_fusionnet_flow",
                               (CLI_SIZE, CLI_SIZE, 3))):
            for i in CLI_IDS:
                img = np.asarray(Image.open(os.path.join(out, folder,
                                                         f"{i:04d}.png")))
                assert img.dtype == np.uint8 and img.shape == shape, (
                    folder, i, img.shape)
        for what in ("flow", "warp"):
            avg = float(re.search(rf"average {what} time: (\S+)", text).group(1))
            say(f"sff cli infer_unfolding run {run} average {what} ms per "
                f"section ({CLI_SIZE}^2)", avg * 1e3)

    pair = [os.path.join(case, "data", "sff", f"{i:04d}.png") for i in (0, 2)]
    for run in (1, 2):
        single = os.path.join(root, f"single_{run}.png")
        t0 = time.perf_counter()
        run_main(f"sff cli infer_interp_single run {run}",
                 infer_interp_single.main,
                 ["-c", os.path.join(case, "cfg.yaml"), "-i1", pair[0],
                  "-i2", pair[1], "-o", single, "--ckpt",
                  os.path.join(case, "interp.pth")],
                 {"sepconv_fwd": 2})
        say(f"sff cli infer_interp_single run {run} ms (main, PNG I/O "
            "included)", (time.perf_counter() - t0) * 1e3)
        assert np.asarray(Image.open(single)).shape == (CLI_SIZE, CLI_SIZE)

    flow_net = load_model(lambda: FusionNet(ngf=32),
                          os.path.join(case, "flow.pth")).cuda().eval()
    k = CLI_IDS[0]
    with torch.inference_mode():
        deg = np.asarray(Image.open(os.path.join(root, "data", "sff",
                                                 f"{k:04d}.png")))
        interp = np.asarray(Image.open(os.path.join(
            case, "out_f32", "sff_interp", f"{k:04d}.png")))
        x = torch.from_numpy(np.stack([deg] * 3 + [interp] * 3)[None]).cuda()
        hp = -(-CLI_SIZE // 16) * 16
        x = torch.nn.functional.pad(x.float() / 255.0, (0, hp - CLI_SIZE,
                                                        0, hp - CLI_SIZE),
                                    mode="replicate")
        flow = flow_net(x)[:, :, :CLI_SIZE, :CLI_SIZE].permute(0, 2, 3, 1)
        epe = float(losses.epe(flow, torch.from_numpy(flows[k][None]).cuda()))
    say(f"sff cli infer_unfolding section {k} EPE against the synthesized "
        "flow (random weights)", epe)
    assert np.isfinite(epe), epe
    return {"unfolding_warps": 2 * n, "single_sepconvs": 4}


# ---------------------------------------------------------------------------
# phase 23: SP training
# ---------------------------------------------------------------------------

# Card-vs-CPU gradient bounds of the SP steps, as fractions of each
# tensor's max |gradient|, fixed before the card's first reading from the
# port's float32-vs-float64 spread on a CPU at 2 x 64^2, K=51 (three
# batches; PERF.md section 6): the IFNet step 1.9e-6..1.8e-5 (the
# bound of phase 9); the fusion step's VFI branch, whose gradients come
# back through the train-mode BN nets, up to 1.2e-4; the train-mode BN
# nets (the correction step, the fusion step's U-Nets) up to 0.13, so two
# float32 sums may differ by twice that. The conv biases that feed a
# train-mode BN have a true gradient of 0: float32 leaves up to 8.8e-7 of
# noise there, bounded absolutely. The BN running statistics are forward
# quantities.
SP_GRAD_BOUNDS = {"ifnet": 1e-4, "vfi_behind_bn": 1e-3, "bn": 0.3}
SP_BN_FED_BIAS_ABS = 1e-5
SP_BN_STATS_BOUND = 1e-4


def write_sp_train_config(root, data, txt, name, **kw):
    """An SP trainer's config as a reference-style flat YAML over the
    quartet tree: the JAX trainers' defaults (no patch_size, batch_size,
    kernel_size or base_lr key), the reference's augmentations, previews
    every 100 steps and a checkpoint every 1000 (and at the last step);
    ``kw`` adds keys."""
    import yaml

    cfg = {"data_folder": data, "data_txt": txt, "random_seed": SEED,
           "if_rotate": True, "if_bdadjust": True,
           "cache_path": os.path.join(root, "caches"),
           "save_path": os.path.join(root, "models", name),
           "valid_freq": 100, "save_freq": 1000, **kw}
    path = os.path.join(root, name + ".yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def run_dir(root, name):
    """The one run directory a trainer made under ``root/models/name``."""
    (run,) = os.listdir(os.path.join(root, "models", name))
    return os.path.join(root, "models", name, run)


def relu_inputs(model, x):
    """Every ReLU input of one forward of ``model`` on ``x``, on the CPU."""
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append(i[0].cpu()))
             for m in model.modules() if isinstance(m, torch.nn.ReLU)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return seen


def sp_step_card_vs_cpu(name, module, cfg, ds):
    """One step of ``module.build(cfg)`` on the card and on the CPU from the
    same seeded weights and batch (2 x SP_CHECK_PATCH^2, float32, TF32
    off): the loss within 1e-5 relative, each gradient within its
    SP_GRAD_BOUNDS fraction of the CPU tensor's max |gradient|, the conv
    biases feeding a train-mode BN within SP_BN_FED_BIAS_ABS, and the BN
    running statistics after the step within SP_BN_STATS_BOUND of each
    tensor's max. The IFNet bounds assume that both sides take the same
    side of every ReLU: an input within float32 rounding of 0 can take the
    other, both sides sound, and move a gradient by percents of its max
    (tests/test_torch_sp_train.py). So the batch is the first of three
    seeded ones on which the card's and the CPU's IFNet forwards agree on
    every ReLU input's sign. Returns the worst gradient error by group."""
    from sstem_tpu_torch.cli import train_sp_interp
    from sstem_tpu_torch.train.trainer import TrainState

    built = {dev: module.build(cfg, 1, dev, seed=SEED) for dev in ("cuda", "cpu")}
    ifnets = {dev: getattr(b[0], "vfi", b[0]) for dev, b in built.items()}
    for draw in range(3):
        rng = np.random.default_rng(SEED + draw)
        samples = [ds.sample(rng) for _ in range(2)]
        batch = {k: torch.from_numpy(np.stack([s[k] for s in samples]))
                 for k in samples[0]}
        if name == "correction":
            break
        x = train_sp_interp.vfi_inputs(batch)
        flips = sum(int(((a > 0) != (b > 0)).sum()) for a, b in zip(
            relu_inputs(ifnets["cuda"], x.cuda()), relu_inputs(ifnets["cpu"], x)))
        say(f"sp train {name} card-vs-cpu batch {draw}: IFNet ReLU inputs "
            "of another sign on the card", flips)
        if flips == 0:
            break
    else:
        raise AssertionError(f"sp train {name}: no batch of three keeps the "
                             "IFNet's ReLU signs on the card")
    out = {}
    for dev, (model, opt, step, _, _) in built.items():
        _, metrics = step(TrainState(model, opt),
                          {k: v.to(dev) for k, v in batch.items()})
        out[dev] = (float(metrics["loss"]), model)
    (loss_card, card), (loss_cpu, cpu) = out["cuda"], out["cpu"]
    say(f"sp train {name} card-vs-cpu loss", [loss_card, loss_cpu])
    assert abs(loss_card - loss_cpu) <= 1e-5 * abs(loss_cpu), (name, loss_card,
                                                              loss_cpu)
    bn_fed, prev = set(), None
    for mod_name, m in cpu.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d) and prev:
            bn_fed.add(prev + ".bias")
        if isinstance(m, torch.nn.Conv2d):
            prev = mod_name
    card_params = dict(card.named_parameters())
    worst = {}
    for pname, p in cpu.named_parameters():
        got, want = card_params[pname].grad.cpu(), p.grad
        err = float((got - want).abs().max())
        if pname in bn_fed:
            group, tol = "bn_fed_bias_abs", SP_BN_FED_BIAS_ABS
        else:
            group = ("ifnet" if name == "interp" else "bn"
                     if name == "correction" or not pname.startswith("vfi.")
                     else "vfi_behind_bn")
            err /= max(float(want.abs().max()), 1e-30)
            tol = SP_GRAD_BOUNDS[group]
        if err > worst.get(group, (0.0, ""))[0]:
            worst[group] = (err, pname)
        assert err <= tol, (name, pname, group, err, tol)
    card_buffers = dict(card.named_buffers())
    for bname, b in cpu.named_buffers():
        if b.is_floating_point():
            err = float((card_buffers[bname].cpu() - b).abs().max()
                        / b.abs().max().clamp_min(1e-30))
            worst["bn_stats"] = max(worst.get("bn_stats", (0.0, "")),
                                    (err, bname))
            assert err <= SP_BN_STATS_BOUND, (name, bname, err)
    for group, (err, pname) in sorted(worst.items()):
        say(f"sp train {name} card-vs-cpu worst {group} error ({pname})", err)
    return worst


def sp_training_phase():
    """Phase 23: the SP trainers at full width on a seeded quartet tree of
    SP_TRAIN_ROWS x SP_TRAIN_SIZE^2 (write_quartet_tree: clean sections from
    synth_stack, sections 2 and 3 darkened inside synth_blob_mask blobs,
    masks a and b from the blobs, interp images): train_sp_interp,
    train_sp_correction and train_sp_fusion (the vfi and denoise branches
    pretrained from the first two runs' checkpoints) for 3 steps each,
    then train_sp_interp --resume-torch from its step-1 checkpoint; each
    run's launches asserted (sepconv forward 4 and backward 4 a step in
    interp and fusion, 4 forwards a preview; none in correction) and its
    signatures checked. Then each build(cfg)'s step on the card against
    the CPU (sp_step_card_vs_cpu), and timed at the JAX defaults (256^2
    crops, batch 1, K=51, float32, TF32 off) with a profile. Returns the
    main runs' launches for the JSON line."""
    from sstem_tpu_torch.cli import (
        train_sp_correction, train_sp_fusion, train_sp_interp,
    )
    from sstem_tpu_torch.compat.config import load_sp_config
    from sstem_tpu_torch.data.providers import Provider, SPDataset
    from sstem_tpu_torch.data.synthetic import write_quartet_tree
    from sstem_tpu_torch.train.trainer import TrainState

    root = os.path.join(OUT, "sp_train")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "data")
    txt = write_quartet_tree(data, SP_TRAIN_ROWS, SP_TRAIN_SIZE, seed=SEED)
    steps = 3
    launches = {}
    cfg_i = write_sp_train_config(root, data, txt, "interp", save_freq=1,
                                  if_use_vfiImg=True)
    # 4 forwards and 4 backwards a step (2 frames x 2 sepconvs), and 4
    # forwards for the step-1 preview
    launches["interp"] = {"sepconv_fwd": 4 * steps + 4,
                          "sepconv_bwd": 4 * steps}
    _, sig = run_main("sp train train_sp_interp", train_sp_interp.main,
                      ["-opt", cfg_i, "--max-iters", str(steps)],
                      launches["interp"])
    want_sig = ("sepconv", SP_TRAIN_BATCH, 1, SP_TRAIN_PATCH, SP_TRAIN_PATCH,
                K, "float32", "float32")
    assert set(sig.maps) == {want_sig, ("sepconv_bwd", *want_sig[1:])}, sig.maps
    interp_dir = run_dir(root, "interp")
    cfg_c = write_sp_train_config(root, data, txt, "correction")
    run_main("sp train train_sp_correction", train_sp_correction.main,
             ["-opt", cfg_c, "--max-iters", str(steps)], {})
    correction_dir = run_dir(root, "correction")
    for d in (interp_dir, correction_dir):
        payload = torch.load(os.path.join(d, "model-%06d.ckpt" % steps),
                             map_location="cpu", weights_only=True)
        assert "optimizer_weights" in payload, d
    # the fusion trainer's pretrained branches under resume_path/{vfi,denoise}
    pretrained = os.path.join(root, "pretrained")
    os.makedirs(pretrained)
    os.symlink(interp_dir, os.path.join(pretrained, "vfi"))
    os.symlink(correction_dir, os.path.join(pretrained, "denoise"))
    fusion_keys = dict(mode="b", vfi_lr_weight=1e-20, denoise_lr_weight=1e-6,
                       if_pretrained=True, resume_path=pretrained,
                       if_pretrained_vfi=True, if_pretrained_denoise=True,
                       vfi_last_iter=steps, denoise_last_iter=steps)
    cfg_f = write_sp_train_config(root, data, txt, "fusion", **fusion_keys)
    launches["fusion"] = dict(launches["interp"])
    text, sig = run_main("sp train train_sp_fusion", train_sp_fusion.main,
                         ["-opt", cfg_f, "--max-iters", str(steps)],
                         launches["fusion"])
    assert "vfi branch loaded" in text and "denoise branch loaded" in text
    assert set(sig.maps) == {want_sig, ("sepconv_bwd", *want_sig[1:])}, sig.maps
    fusion_dir = run_dir(root, "fusion")
    assert sorted(os.listdir(fusion_dir)) == [
        "denoise", "fusion", "model-%06d.ckpt" % steps, "vfi"], fusion_dir
    vfi_in = torch.load(os.path.join(interp_dir, "model-%06d.ckpt" % steps),
                        map_location="cpu", weights_only=True)["model_weights"]
    vfi_out = torch.load(os.path.join(fusion_dir, "vfi",
                                      "model-%06d.ckpt" % steps),
                         map_location="cpu", weights_only=True)["model_weights"]
    # the VFI branch at 1e-4 x 1e-20 comes out of 3 steps as it went in
    assert all(torch.equal(vfi_in[k], v) for k, v in vfi_out.items())
    say("sp train fusion: VFI branch bit-identical after steps", steps)
    cfg_r = write_sp_train_config(root, data, txt, "interp_resumed",
                                  if_use_vfiImg=True)
    # steps 2 and 3, no preview (the next is at step 100)
    run_main("sp train train_sp_interp --resume-torch", train_sp_interp.main,
             ["-opt", cfg_r, "--max-iters", str(steps), "--resume-torch",
              os.path.join(interp_dir, "model-000001.ckpt")],
             {"sepconv_fwd": 4 * (steps - 1), "sepconv_bwd": 4 * (steps - 1)})
    payload = torch.load(os.path.join(run_dir(root, "interp_resumed"),
                                      "model-%06d.ckpt" % steps),
                         map_location="cpu", weights_only=True)
    opt_steps = {int(v["step"])
                 for v in payload["optimizer_weights"]["state"].values()}
    say("sp train interp resumed optimizer steps", sorted(opt_steps))
    assert opt_steps == {steps}, opt_steps

    # each build(cfg)'s step: card vs CPU, then timed at the workload
    check_ds = SPDataset(data, txt, patch_size=SP_CHECK_PATCH)
    ds = SPDataset(data, txt, patch_size=SP_TRAIN_PATCH)
    ms = {}
    for name, module, cfg_path in (("interp", train_sp_interp, cfg_i),
                                   ("correction", train_sp_correction, cfg_c),
                                   ("fusion", train_sp_fusion, cfg_f)):
        cfg = load_sp_config(cfg_path)
        sp_step_card_vs_cpu(name, module, cfg, check_ds)
        torch.cuda.empty_cache()
        model, opt, step, _, _ = module.build(cfg, 1, "cuda", seed=SEED)
        provider = Provider(ds, SP_TRAIN_BATCH, seed=SEED, device="cuda")
        try:
            # each step restores sections 2 and 3 of a quartet
            ms[name], per = time_train_step(
                f"sp train {name}", step, TrainState(model, opt),
                provider.next, pixels=2 * SP_TRAIN_BATCH * SP_TRAIN_PATCH ** 2)
        finally:
            provider.close()
        want = {} if name == "correction" else {"sepconv_fwd": 4,
                                                "sepconv_bwd": 4}
        assert per == want, (name, per)
        del model, opt
        torch.cuda.empty_cache()
    say("sp train ms_per_step interp, correction, fusion",
        [ms["interp"], ms["correction"], ms["fusion"]])
    return launches


# ---------------------------------------------------------------------------
# phase 24: the data tools and the perceptual loss
# ---------------------------------------------------------------------------

# The simulators' workload: SimuSFF at its default 1024^2 crop of
# SIM_SIZE^2 sections, simu_sp on sections 2 and 3 of SIM_QUARTETS
# quartets at SIM_SIZE^2 with a synthetic bank of SIM_BANK blobs; the
# valid set over a triplet tree of TRAININGSET_ROWS x TRAININGSET_SIZE^2
# (400^2 crops to 256^2, make_validset's defaults).
SIM_SIZE, SIM_SFF_CROP, SIM_SFF_SECTIONS = 1250, 1024, 4
SIM_QUARTETS, SIM_BANK = 4, 24
# Card-vs-CPU bounds of step 5 (2 x 1 x 64^2, float32, TF32 off), fixed
# before the card's first reading from the port's float32-vs-float64 spread
# on a CPU (three draws; PERF.md section 6): the perceptual loss
# 1.1e-8..2.1e-8 relative, its gradient 3.1e-7..3.5e-7 of the max where no
# ReLU input sits within float32 rounding of 0 (a draw with one: 1.4e-2),
# MS-SSIM 5e-8..2e-7 absolute, the GAN terms below 6e-8. Scalars within
# these absolute or relative bounds, the gradient within 1e-4 of its max
# (phase 9's bound), the CPU's VGG taking the card's side at every ReLU
# and pool (loss_checks_card_vs_cpu).
LOSS_CHECK_SHAPE = (2, 1, 64, 64)
LOSS_CHECK_BOUNDS = {"perceptual_rel": 1e-5, "perceptual_grad": 1e-4,
                     "ms_ssim": 1e-5, "psnr": 1e-4, "ssim": 1e-5,
                     "gan": 1e-6}


def timed_main(label, main, argv, want):
    """``run_main``, and the host seconds it took."""
    t0 = time.perf_counter()
    text, sig = run_main(label, main, argv, want)
    return text, sig, time.perf_counter() - t0


def write_pngs(folder, images):
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    for name, img in images.items():
        Image.fromarray(img).save(os.path.join(folder, name))


def read_png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


def simulators_step(root):
    """Step 1: simulate_sff at --size SIM_SFF_CROP on SIM_SFF_SECTIONS clean
    SIM_SIZE^2 sections, and simulate_sp --synthetic-bank SIM_BANK on
    sections 2 and 3 of SIM_QUARTETS quartets at SIM_SIZE^2, written into
    the quartet tree; host seconds a section. Neither launches a kernel
    (host code in both packages). Returns the quartet tree."""
    from sstem_tpu_torch.cli import simulate_sff, simulate_sp
    from sstem_tpu_torch.data import synth_stack
    from sstem_tpu_torch.data.sim_sp import MaskBank

    sff_in, sff_out = os.path.join(root, "sff_clean"), os.path.join(root, "sff_sim")
    stack = synth_stack(SIM_SFF_SECTIONS, SIM_SIZE, SIM_SIZE, seed=SEED)
    write_pngs(sff_in, {f"{i:04d}.png": s for i, s in enumerate(stack)})
    _, _, secs = timed_main(
        "data tools simulate_sff", simulate_sff.main,
        ["-p", sff_in, "-s", str(SIM_SFF_CROP), "-o", sff_out, "--seed",
         str(SEED)], {})
    say(f"data tools simulate_sff host s per {SIM_SIZE}^2 section "
        f"({SIM_SFF_CROP}^2 crop, noise on)", secs / SIM_SFF_SECTIONS)
    for i in range(SIM_SFF_SECTIONS):
        deg = read_png(os.path.join(sff_out, f"{i:04d}_SimuSFF.png"))
        flow = read_png(os.path.join(sff_out, f"{i:04d}_SimuSFF_flow.png"))
        assert deg.shape == (SIM_SFF_CROP, SIM_SFF_CROP), deg.shape
        assert flow.shape == (SIM_SFF_CROP, SIM_SFF_CROP, 3), flow.shape
        assert (deg == 0).sum() >= 100, i  # the fold strip

    tree, clean = os.path.join(root, "sp_tree"), os.path.join(root, "sp_clean23")
    stack = synth_stack(SIM_QUARTETS + 3, SIM_SIZE, SIM_SIZE, seed=SEED + 1)
    quartets = {f"{q + 1:04d}_{j + 1}.png": stack[q + j]
                for q in range(SIM_QUARTETS) for j in range(4)}
    write_pngs(tree, quartets)
    write_pngs(clean, {n: img for n, img in quartets.items()
                       if n[5] in "23"})
    t0 = time.perf_counter()
    bank = MaskBank.synthetic(n=SIM_BANK, seed=SEED)
    say(f"data tools MaskBank.synthetic({SIM_BANK}) host s",
        time.perf_counter() - t0)
    say("data tools mask bank size", len(bank))
    _, _, secs = timed_main(
        "data tools simulate_sp", simulate_sp.main,
        ["-p", clean, "-o", tree, "--synthetic-bank", str(SIM_BANK),
         "--seed", str(SEED)], {})
    n = 2 * SIM_QUARTETS
    say(f"data tools simulate_sp host s per {SIM_SIZE}^2 section (the "
        "bank's build included)", secs / n)
    changed = []
    for name in sorted(quartets):
        if name[5] not in "23":
            continue
        stem = os.path.join(tree, name[:-4])
        deg = read_png(stem + "_degra.png")
        for suffix in ("_degra_maska.png", "_degra_maskb.png"):
            m = read_png(stem + suffix)
            assert m.shape == deg.shape == (SIM_SIZE, SIM_SIZE), (stem, m.shape)
        changed.append(float((deg != quartets[name]).mean()))
    say("data tools simulate_sp share of pixels changed per section", changed)
    assert min(changed) > 0, changed
    return tree


def sp_correction_on_simulated(root, tree, steps=3):
    """Step 2: gen_data_txt --dialect sp lists the simulated quartets, and
    train_sp_correction trains 3 steps on them at the JAX defaults (no
    kernel launches: the correction net has no sepconv)."""
    from sstem_tpu_torch.cli import gen_data_txt, train_sp_correction
    from sstem_tpu_torch.data.providers import SPDataset

    run_cli("data tools gen_data_txt sp", gen_data_txt.main,
            ["-f", tree, "-n", str(SIM_QUARTETS), "--dialect", "sp"], {})
    txt = os.path.join(tree, "sp_train_data.txt")
    ds = SPDataset(tree, txt)
    assert len(ds) == SIM_QUARTETS
    sample = ds.get(0, np.random.default_rng(SEED))
    assert sample["img_2_degra"].shape == (1, SP_TRAIN_PATCH, SP_TRAIN_PATCH)
    cfg = write_sp_train_config(root, tree, txt, "correction_simulated")
    run_main("data tools train_sp_correction on simulated data",
             train_sp_correction.main, ["-opt", cfg, "--max-iters", str(steps)],
             {})
    payload = torch.load(os.path.join(run_dir(root, "correction_simulated"),
                                      "model-%06d.ckpt" % steps),
                         map_location="cpu", weights_only=True)
    assert "optimizer_weights" in payload
    (cache,) = [d for d in os.listdir(os.path.join(root, "caches"))
                if d.endswith("sp_correction")]
    with open(os.path.join(root, "caches", cache, "loss.txt")) as f:
        loss = float(f.read().split("loss = ")[1].split()[0])
    say("data tools train_sp_correction step-1 loss on the simulated data",
        loss)
    assert np.isfinite(loss), loss


def unfolding_with_valid_set(root, steps=3):
    """Step 3: gen_data_txt --dialect sff lists a seeded triplet tree of
    TRAININGSET_ROWS x TRAININGSET_SIZE^2 (the rows write_triplet_tree
    writes); the valid set's items (make_validset's defaults: 400^2 crops
    to 256^2) are built in memory, since make_validset's HDF5 sidecars need
    h5py, which this machine lacks (the tests hold make_validset, its
    files and train_unfolding's validation on them on a CPU); then
    train_unfolding trains 3 steps (the preview's warp asserted) and its
    checkpoint's EPE over the valid items is finite."""
    from sstem_tpu_torch.cli import _sff, gen_data_txt, train_unfolding
    from sstem_tpu_torch.compat.config import load_sff_config
    from sstem_tpu_torch.compat.weights import load_reference
    from sstem_tpu_torch.data import write_triplet_tree
    from sstem_tpu_torch.data.providers import _gray6
    from sstem_tpu_torch.data.validset import unfolding_valid_items

    data = os.path.join(root, "sff_tree")
    rows = write_triplet_tree(data, n_triplets=TRAININGSET_ROWS,
                              size=TRAININGSET_SIZE, seed=SEED)
    os.remove(os.path.join(data, "train_data.txt"))
    run_cli("data tools gen_data_txt sff", gen_data_txt.main,
            ["-f", data, "-n", str(TRAININGSET_ROWS), "--dialect", "sff"], {})
    with open(os.path.join(data, "train_data.txt")) as f:
        assert f.read().splitlines() == rows
    with open(os.path.join(data, "interp_train_data.txt"), "w") as f:
        f.write("\n".join(r.split()[1] for r in rows) + "\n")
    say("data tools h5py installed (make_validset's HDF5 sidecars)",
        importlib.util.find_spec("h5py") is not None)
    t0 = time.perf_counter()
    # (inputs (6, H, W), flow2 (2, H, W)), what UnfoldingValidDataset reads
    # from make_validset's files
    valid = [(_gray6(it["degraded"], it["interp"]),
              np.ascontiguousarray(it["flow2"].transpose(2, 0, 1)))
             for it in unfolding_valid_items(data, [r.split() for r in rows],
                                             seed=SEED)]
    say(f"data tools valid set host s per item ({SFF_TRAIN_CROP}^2 to "
        f"{SFF_TRAIN_DET}^2)", (time.perf_counter() - t0) / len(valid))
    cfg_path = write_sff_train_config(root, data, "unfold_simulated", {})
    # the host path's step-1 preview warps once
    _, sig = run_main("data tools train_unfolding", train_unfolding.main,
                      ["-c", cfg_path, "--max-iters", str(steps)],
                      {"warp_bilinear": 1})
    assert set(sig.warps) == {(1, SFF_TRAIN_DET, SFF_TRAIN_DET)}, sig.warps
    save = os.path.join(root, "models")
    (run,) = [d for d in os.listdir(save) if d.endswith("unfold_simulated")]
    model, _, _, eval_fn, _ = train_unfolding.build(load_sff_config(cfg_path),
                                                    "cuda", SEED)
    load_reference(model, os.path.join(save, run, "model-%06d.ckpt" % steps))
    epe = _sff.epe_valid_loop(eval_fn, valid, "cuda")
    say(f"data tools train_unfolding step-{steps} EPE over the "
        f"{len(valid)} valid items", epe)
    assert np.isfinite(epe) and epe > 0, epe
    return 1


def write_perceptual_config(root):
    """Phase 10's interp config (its triplet tree and validation list) with
    TRAIN.loss perceptual, and the seeded VGG19 file in torchvision's
    layout. Returns (config path, VGG path)."""
    import yaml

    from sstem_tpu_torch.models.vgg import seeded_torchvision_vgg19

    with open(os.path.join(OUT, "interp_k51_b32.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["NAME"] = "interp_k51_b32_perceptual"
    cfg["TRAIN"]["loss"] = "perceptual"
    cfg_path = os.path.join(root, "interp_perceptual.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    vgg_path = os.path.join(root, "vgg19_seeded.pth")
    torch.save(seeded_torchvision_vgg19(seed=SEED), vgg_path)
    return cfg_path, vgg_path


def perceptual_training(root, steps=3, timed=10, warm=3):
    """Step 4: train_interp.main with TRAIN.loss perceptual and
    --vgg-weights at phase 10's workload for 3 steps (sepconv forward 2
    and backward 2 a step, 2 for the preview and 2 for each of the two
    validation images, the signatures phase 10's), then the step of
    build(cfg) with L1 and with the perceptual loss timed in this call;
    no gradient reaches a VGG parameter. Returns the main run's launches
    and the two ms/step."""
    from sstem_tpu_torch.cli import train_interp
    from sstem_tpu_torch.compat.config import load_sff_config
    from sstem_tpu_torch.data.providers import InterpTrainDataset, Provider
    from sstem_tpu_torch.models.vgg import VGG19Features
    from sstem_tpu_torch.train.trainer import TrainState

    cfg_path, vgg_path = write_perceptual_config(root)
    launches = {"sepconv_fwd": 2 * steps + 2 + 2 * 2, "sepconv_bwd": 2 * steps}
    _, sig = run_main("perceptual train_interp", train_interp.main,
                      ["-c", cfg_path, "--max-iters", str(steps),
                       "--vgg-weights", vgg_path], launches)
    train_sig = ("sepconv", TRAIN_BATCH, 1, TRAIN_PATCH, TRAIN_PATCH, K,
                 "float32", "float32")
    assert set(sig.maps) == {train_sig, ("sepconv_bwd", *train_sig[1:]),
                             ("sepconv", 1, *train_sig[2:]),
                             ("sepconv", 1, 1, 320, 320, *train_sig[5:])}, sig.maps

    data = os.path.join(OUT, "data")
    provider = Provider(InterpTrainDataset(data, patch_size=(TRAIN_PATCH,) * 2),
                        TRAIN_BATCH, seed=SEED, device="cuda")
    try:
        batch = provider.next()
    finally:
        provider.close()
    ms = {}
    for loss in ("L1", "perceptual"):
        cfg = load_sff_config(cfg_path)
        cfg.TRAIN.loss = loss
        model, opt, step, _, _, crit = train_interp.build(
            cfg, "cuda", seed=SEED,
            vgg_weights=vgg_path if loss == "perceptual" else None)
        ms[loss], per = time_train_step(
            f"perceptual train {loss}", step, TrainState(model, opt),
            lambda: batch, timed=timed, warm=warm,
            pixels=TRAIN_BATCH * TRAIN_PATCH ** 2)
        assert per == {"sepconv_fwd": 2, "sepconv_bwd": 2}, (loss, per)
        if loss == "perceptual":
            vgg = crit.args[0]
            assert isinstance(vgg, VGG19Features) and not vgg.training
            assert all(p.grad is None and not p.requires_grad
                       for p in vgg.parameters())
            assert not any(k.startswith("features.")
                           for k in model.state_dict())
            say("perceptual train: VGG parameters with a gradient", 0)
        del model, opt, step, crit
        torch.cuda.empty_cache()
    say("perceptual train ms_per_step L1, perceptual",
        [ms["L1"], ms["perceptual"]])
    say("perceptual train ms_per_step ratio perceptual / L1",
        ms["perceptual"] / ms["L1"])
    return launches, ms


def vgg_sides(vgg, replay=None):
    """Forward hooks on every ReLU and max pool of ``vgg``. Without
    ``replay`` they record, in call order, the side of each ReLU input and
    the argmax of each pool; with a recorded list the layers take those
    sides instead of their own (a ReLU passes its input where the record
    says positive, a pool gathers at the recorded argmax), so that a
    second forward follows the first one's path through every kink.
    Returns (the list, the hook handles)."""
    import torch.nn.functional as F

    seen = [] if replay is None else list(replay)
    step = iter(range(len(seen)))

    def hook(m, i, o):
        z = i[0]
        if replay is None:
            seen.append((z.detach() > 0).cpu() if isinstance(m, torch.nn.ReLU)
                        else F.max_pool2d(z.detach(), 2, 2,
                                          return_indices=True)[1].cpu())
            return None
        side = seen[next(step)].to(z.device)
        if isinstance(m, torch.nn.ReLU):
            return z * side.to(z.dtype)
        return z.flatten(2).gather(2, side.flatten(2)).view_as(o)

    hooks = [m.register_forward_hook(hook) for m in vgg.modules()
             if isinstance(m, (torch.nn.ReLU, torch.nn.MaxPool2d))]
    return seen, hooks


def loss_checks_card_vs_cpu(vgg_path):
    """Step 5: the perceptual loss and its gradient with respect to the
    prediction, MS-SSIM, metrics.psnr and metrics.ssim and the three GAN
    modes on the card against the CPU at LOSS_CHECK_SHAPE (float32, TF32
    off), within LOSS_CHECK_BOUNDS. A ReLU input or pool window within
    float32 rounding of a kink may take another side in cuDNN's sums than
    in the CPU's (both sound) and move the gradient by percents of its max:
    the card's first run found 1, 4 and 6 such sides on three seeded draws.
    So the CPU's VGG takes the card's side at every ReLU and pool
    (``vgg_sides``), and the gradient bound measures the convolutions'
    rounding alone; the sides that differed are counted."""
    import copy

    from sstem_tpu_torch import losses, metrics
    from sstem_tpu_torch.cli import _sff

    vggs = {"cuda": _sff.load_vgg_apply(vgg_path, "cuda")}
    vggs["cpu"] = copy.deepcopy(vggs["cuda"]).cpu()
    rng = np.random.default_rng(SEED)
    pred = torch.from_numpy(rng.random(LOSS_CHECK_SHAPE, dtype=np.float32))
    target = torch.from_numpy(np.clip(
        pred.numpy() + rng.normal(0, 0.1, LOSS_CHECK_SHAPE), 0, 1).astype(
            np.float32))
    out, card_sides = {}, None
    for dev in ("cuda", "cpu"):
        sides, hooks = vgg_sides(vggs[dev], card_sides)
        try:
            p = pred.to(dev).requires_grad_(True)
            t = target.to(dev)
            loss = losses.perceptual_loss(vggs[dev], p, t)
            loss.backward()
        finally:
            for h in hooks:
                h.remove()
        if card_sides is None:
            card_sides = sides
        a, b = p.detach() * 255, t * 255
        out[dev] = {
            "perceptual": loss.item(), "grad": p.grad.cpu(),
            "ms_ssim": float(losses.ms_ssim(a, b)),
            "psnr": float(metrics.psnr(p.detach(), t)),
            "ssim": float(metrics.ssim(a[:, 0], b[:, 0])),
            **{f"gan {mode} {term}": float(fn(p.detach() - 0.5, t - 0.5, mode))
               for mode in ("lsgan", "vanilla", "wgangp")
               for term, fn in (("d_loss", losses.d_loss),
                                ("g_loss", lambda f, r, m: losses.g_loss(f, m)))}}
    cpu_sides, hooks = vgg_sides(vggs["cpu"])
    try:
        with torch.no_grad():
            losses.perceptual_loss(vggs["cpu"], pred, target)
    finally:
        for h in hooks:
            h.remove()
    assert len(cpu_sides) == len(card_sides)
    say("loss checks VGG ReLU sides and pool argmaxes the CPU's own forward "
        "takes otherwise than the card (the CPU took the card's)",
        sum(int((a != b).sum()) for a, b in zip(card_sides, cpu_sides)))
    card, cpu = out["cuda"], out["cpu"]
    errors = {}
    for key, want in cpu.items():
        got = card[key]
        if key == "grad":
            err = float((got - want).abs().max() / want.abs().max())
            bound = LOSS_CHECK_BOUNDS["perceptual_grad"]
        elif key == "perceptual":
            err = abs(got - want) / abs(want)
            bound = LOSS_CHECK_BOUNDS["perceptual_rel"]
        else:
            err = abs(got - want)
            bound = LOSS_CHECK_BOUNDS[key.split()[0]]
            say(f"loss checks {key} card, cpu", [got, want])
        errors[key] = err
        say(f"loss checks {key} card-vs-cpu error (bound {bound})", err)
        assert err <= bound, (key, err, bound)
    return errors


def data_tools_phase():
    """Phase 24: the data tools and the perceptual loss (steps 1-5 above).
    Returns the launches of the new runs for the JSON line."""
    root = os.path.join(OUT, "data_tools")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    tree = simulators_step(root)
    sp_correction_on_simulated(root, tree)
    unfolding_warps = unfolding_with_valid_set(root)
    launches, ms = perceptual_training(root)
    loss_checks_card_vs_cpu(os.path.join(root, "vgg19_seeded.pth"))
    return {"perceptual": launches, "unfolding_warps": unfolding_warps,
            "ms": ms}


# ---------------------------------------------------------------------------
# phase 25: the sharded stack restore, tiled inference, the debug tools
# ---------------------------------------------------------------------------

# restore_stack_sharded at full width with halo exchange (rows 1250 + 2 x
# 256 padded to 1792, two slabs of 896 + 2 x 256 = 1408 rows each), its
# card-vs-CPU size, and infer_tiled's tile and halo
SHARDED_HALO = 256
SMALL_SIZE, SMALL_HALO = 256, 64
TILE, TILE_HALO = 512, 64
# uint8 agreement of two sound runs (tests/test_pipeline_sharded.py:33-48)
MAX_LEVELS, MAX_SHARE = 1, 1e-3
SHARDED_PATHS = {"cudnn": {},
                 "packed_fused_tail": {"packed_conv": True,
                                       "fused_head_tail": True}}


def zero_canvas(stack):
    """The stack zero-padded to multiples of 32, as restore_stack_sharded
    pads it with one space shard and halo 0."""
    _, h, w = stack.shape
    return np.pad(stack, [(0, 0), (0, -h % 32), (0, -w % 32)])


def level_diff(label, got, want, ids, keys, bound=True):
    """Prints, per output, the largest uint8 level difference over the
    sections and the share of pixels that differ; with ``bound``, fails
    past MAX_LEVELS or MAX_SHARE."""
    for key in keys:
        d = np.stack([np.abs(got[i][key].astype(np.int16)
                             - want[i][key].astype(np.int16)) for i in ids])
        worst, share = int(d.max()), float((d > 0).mean())
        say(f"{label} {key} max_level_diff", worst)
        say(f"{label} {key} share of pixels that differ", share)
        if bound:
            assert worst <= MAX_LEVELS and share < MAX_SHARE, (label, key,
                                                               worst, share)


def counted_run(label, path, units, unit, fn):
    """``fn()`` with every kernel's count from zero and its signatures
    recorded; asserts the path's launches per unit (PATH_LAUNCHES: one
    section call per slab or per tiled batch) and that the signatures are
    in the check lists. Returns (fn's result, launches)."""
    wrappers = counted_kernels()
    for fn_ in wrappers.values():
        fn_.launches = 0
    with KernelSignatures() as sig:
        out = fn()
        torch.cuda.synchronize()
    launches = {k: f.launches for k, f in wrappers.items()}
    for k, n in launches.items():
        if n:
            say(f"{label} {k} launches (per {unit})", f"{n} ({n / units})")
    want = {k: PATH_LAUNCHES[path].get(k, 0) * units for k in wrappers}
    assert launches == want, (label, launches, want)
    report_signatures(label, sig, units, unit,
                      check_channels(SFF_CONV_CHECKS)
                      | check_channels(DECONV_CHECKS, "deconv2x"))
    return out, launches, sig


def sharded_run(label, path, pipe, stack, ids, mesh, halo):
    """One restore_stack_sharded call through counted_run; checks the
    result's keys, dtypes and shapes and that the flow is finite."""
    n_dp, n_sp = mesh.shape["data"], mesh.shape["space"]
    slabs = -(-len(ids) // n_dp) * n_dp * n_sp
    out, launches, sig = counted_run(
        label, path, slabs, "slab",
        lambda: pipe.restore_stack_sharded(stack, ids, mesh, halo=halo))
    _, h, w = stack.shape
    assert sorted(out) == sorted(ids)
    for i in ids:
        assert set(out[i]) == {"interp", "fused", "warped", "stitch", "flow"}
        for key in ("interp", "fused", "warped", "stitch"):
            assert out[i][key].dtype == np.uint8 and out[i][key].shape == (h, w)
        assert out[i]["flow"].shape == (h, w, 2)
        assert np.isfinite(out[i]["flow"]).all(), (label, i)
    say(f"{label} interp mean level",
        float(np.mean([out[i]["interp"] for i in ids])))
    say(f"{label} fused mean level",
        float(np.mean([out[i]["fused"] for i in ids])))
    return out, launches, sig


def ms_per_section(label, fn, sections):
    """Host clock around ``fn()`` ending in a synchronise, the median of 3
    per section; the caller has made one warm call."""
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1000 / sections
    say(f"{label} ms_per_section (median of 3)", ms)
    say(f"{label} ms_per_section runs", [t * 1000 / sections for t in times])
    return ms


def add_launches(total, launches):
    for k, n in launches.items():
        total[k] = total.get(k, 0) + n


def sharded_phase(gen):
    """Phase 25 on the one card, the mesh's devices repeated:

    (a) restore_stack_sharded data-parallel only (dp 2, halo 0) on phase
        6's stack, both bf16 paths, against restore_stack on the same
        pipeline and the same zero-padded canvas (the sharded path pads
        with zeros where restore_stack edge-pads; on the unpadded stack the
        two differ by design over the receptive field of the pad band,
        printed, not bounded); timed.
    (b) dp 2 x sp 2 with halo exchange: at 2 x 256^2 (K=51, halo 64,
        float32) the CPU pipeline's call on a card mesh (its models copied
        to the card, the slabs and halos copied there) against the same
        call on a CPU mesh (the plain kernels), with the nan checks on;
        at 1250^2 with halo 256 on both bf16 paths, timed.
    (c) infer_tiled of the section function (tile 512, halo 64, float32)
        at 1250^2 with no mesh and on a 2-device mesh, the two within a
        uint8 level; timed beside infer_full.
    (d) profile_trace around (b)'s card call at 256^2, its trace file
        read back; the phase's StepTimer report.

    Returns the sharded and tiled runs' launches and the slab and tile
    signatures' kernel timings for the JSON line."""
    import torch.nn.functional as F

    from sstem_tpu_torch import config
    from sstem_tpu_torch.data import synth_stack
    from sstem_tpu_torch.infer import infer_full, infer_tiled
    from sstem_tpu_torch.kernels import pool2x, pool2x_plain, serving_warp
    from sstem_tpu_torch.ops.warp import spatial_transform
    from sstem_tpu_torch.parallel import make_mesh
    from sstem_tpu_torch.parallel.mesh import canonical_device
    from sstem_tpu_torch.utils import StepTimer, enable_nan_checks, profile_trace

    bf16, f32 = config.SERVING_DTYPE, config.PARITY_DTYPE
    timer = StepTimer()
    card = canonical_device(DEV)
    dp = make_mesh(n_data=2, devices=[card] * 2)
    dpsp = make_mesh(n_data=2, n_space=2, devices=[card] * 4)
    stack = synth_stack(25, 1250, 1250, seed=0)
    ids = list(range(1, 24, 2))
    _, h, w = stack.shape
    canvas = zero_canvas(stack)
    out = {"sharded": {}, "tiled": {}, "ms": {}}
    packed_sig = None

    for path, options in SHARDED_PATHS.items():
        pipe = build_pipeline(DEV, bf16, **options)
        label = f"25a dp2 halo0 bfloat16 {path}"
        with timer.phase(f"a {path}"):
            got, launches, _ = sharded_run(label, path, pipe, stack, ids, dp, 0)
            add_launches(out["sharded"], launches)
            want = pipe.restore_stack(canvas, ids, chunk=1)
            want = {i: {k: v[:h, :w] for k, v in r.items()} for i, r in
                    want.items()}
            level_diff(f"{label} vs restore_stack on the canvas", got, want,
                       ids, ("interp", "fused", "stitch"))
            level_diff(f"{label} vs restore_stack on the unpadded stack "
                       "(zero vs edge pad, by design)", got,
                       pipe.restore_stack(stack, ids, chunk=1), ids,
                       ("interp", "fused", "stitch"), bound=False)
            out["ms"][f"a {path}"] = ms_per_section(
                label, lambda: pipe.restore_stack_sharded(stack, ids, dp,
                                                          halo=0), len(ids))
        label = f"25b dp2xsp2 halo{SHARDED_HALO} bfloat16 {path}"
        with timer.phase(f"b {path}"):
            _, launches, sig = sharded_run(label, path, pipe, stack, ids, dpsp,
                                           SHARDED_HALO)
            add_launches(out["sharded"], launches)
            out["ms"][f"b {path}"] = ms_per_section(
                label, lambda: pipe.restore_stack_sharded(
                    stack, ids, dpsp, halo=SHARDED_HALO), len(ids))
            if path == "packed_fused_tail":
                packed_sig = sig
        del pipe
        torch.cuda.empty_cache()

    with timer.phase("b card vs cpu"):
        small = synth_stack(5, SMALL_SIZE, SMALL_SIZE, seed=0)
        cpu_pipe = build_pipeline("cpu", f32)
        cpu_mesh = make_mesh(n_data=2, n_space=2, devices=["cpu"] * 4)
        want = cpu_pipe.restore_stack_sharded(small, [1, 3], cpu_mesh,
                                              halo=SMALL_HALO)
        label = (f"25b dp2xsp2 halo{SMALL_HALO} float32 {SMALL_SIZE}^2 "
                 "card vs cpu")
        enable_nan_checks(True)
        try:
            got, launches, _ = sharded_run(label, "cudnn", cpu_pipe, small,
                                           [1, 3], dpsp, SMALL_HALO)
        finally:
            enable_nan_checks(False)
        add_launches(out["sharded"], launches)
        level_diff(label, got, want, [1, 3],
                   ("interp", "fused", "warped", "stitch"))
        flow_err = max(float(np.abs(got[i]["flow"] - want[i]["flow"]).max())
                       for i in (1, 3))
        say(f"{label} flow max_abs_err", flow_err)
        assert flow_err <= 1e-3, flow_err

    with timer.phase("d profile_trace"):
        logdir = os.path.join(OUT, "trace25")
        shutil.rmtree(logdir, ignore_errors=True)
        with profile_trace(logdir):
            cpu_pipe.restore_stack_sharded(small, [1, 3], dpsp, halo=SMALL_HALO)
            torch.cuda.synchronize()
        traces = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
        assert len(traces) == 1, traces
        with open(os.path.join(logdir, traces[0])) as f:
            events = json.load(f)["traceEvents"]
        kernels = sum(e.get("cat") == "kernel" for e in events)
        say("25d profile_trace of (b)'s card call: events, kernel events",
            (len(events), kernels))
        assert kernels, "profile_trace recorded no kernel on the card"
        del cpu_pipe

    with timer.phase("c infer_tiled"):
        pipe = build_pipeline(DEV, f32)
        i = ids[0]
        x3 = torch.from_numpy(np.stack([stack[i - 1], stack[i + 1], stack[i]],
                                       -1)).to(card).float() / 255.0

        def section(x):
            interp, fused, warped, flow = pipe.section(x.permute(0, 3, 1, 2))
            return torch.cat([torch.stack([interp, fused, warped], -1), flow],
                             -1)

        tiled = {}
        for name, mesh in (("no mesh", None), ("2-device mesh", dp)):
            n_tiles = -(-h // TILE) * -(-w // TILE)
            batch = 4 if mesh is None else max(4, mesh.size)
            calls = -(-n_tiles // batch) * (1 if mesh is None else 2)
            label = f"25c infer_tiled {TILE}+{TILE_HALO} float32 {name}"
            tiled[name], launches, _ = counted_run(
                label, "cudnn", calls, "call", lambda: infer_tiled(
                    section, x3, TILE, TILE_HALO, mesh=mesh))
            add_launches(out["tiled"], launches)
            assert tiled[name].shape == (h, w, 5)
            assert bool(torch.isfinite(tiled[name]).all()), label
            out["ms"][f"c {name}"] = ms_per_section(
                label, lambda: infer_tiled(section, x3, TILE, TILE_HALO,
                                           mesh=mesh), 1)
        a, b = (torch.floor(t[..., :3].clamp(0, 1) * 255).to(torch.int16)
                for t in tiled.values())
        d = (a - b).abs()
        say("25c infer_tiled mesh vs no mesh max_level_diff", int(d.max()))
        say("25c infer_tiled mesh vs no mesh share of pixels that differ",
            float((d > 0).float().mean()))
        assert int(d.max()) <= MAX_LEVELS
        full = infer_full(section, x3[None])
        assert full.shape == (1, h, w, 5) and bool(torch.isfinite(full).all())
        out["ms"]["c infer_full"] = ms_per_section(
            "25c infer_full float32", lambda: infer_full(section, x3[None]), 1)
        del pipe

    with timer.phase("kernels at the slab shapes"):
        # one slab of (b) at full width: half the canvas rows, two halos
        canvas_rows = -(-(h + 2 * SHARDED_HALO) // 64) * 64
        n, hs, ws = 1, canvas_rows // 2 + 2 * SHARDED_HALO, -(-w // 32) * 32
        times = {}
        sep = (n, 1, hs, ws, K, "bfloat16", "bfloat16")
        times["sepconv"] = time_sepconv(*sep, gen)
        say_timing(f"sepconv_fwd[restore_stack_sharded {n}x1x{hs}x{ws} bf16]",
                   times["sepconv"])
        tile_sep = (4, 1, 640, 640, K, "float32", "float32")
        times["sepconv_tiled"] = time_sepconv(*tile_sep, gen)
        say_timing("sepconv_fwd[infer_tiled 4x1x640^2 f32]",
                   times["sepconv_tiled"])
        for shape in ((n, hs, ws), (4, 640, 640)):
            im, flow = warp_inputs(*shape, gen)
            times[shape] = timing(
                cuda_ms(lambda: serving_warp(im, flow), reps=20),
                cuda_ms(lambda: spatial_transform(im, flow), reps=5), None,
                (shape[0] * shape[1] * shape[2] * (4 + 8 + 4) / HBM_BYTES_PER_S
                 * 1e3, "bytes"))
            say_timing(f"warp_bilinear[{shape[0]}x{shape[1]}x{shape[2]}]",
                       times[shape])
        slabs = len(ids) * 2
        err = {"conv3x3_fused": check_conv(n, hs, ws, 32, 32, "relu", None, gen),
               "deconv2x_fused": check_deconv(n, hs // 2, ws // 2, 64, 32,
                                              "relu", None, gen),
               "pool2x": check_pool(n, hs, ws, 32, "max", gen)}
        times.update(time_conv_rows([(n, hs, ws, 32, 32, None)], gen,
                                    packed_sig.calls, slabs))
        times.update(time_deconv_rows([(n, hs // 2, ws // 2, 64, 32, None)],
                                      gen, packed_sig.calls, slabs))
        x = randn((n, hs, ws, 32), gen)
        times[f"pool2x[max@{n}x{hs}x{ws}]"] = timing(
            cuda_ms(lambda: pool2x(x, "max"), 50, 3),
            cuda_ms(lambda: pool2x_plain(x, "max"), 5),
            cuda_ms(lambda: F.max_pool2d(x.permute(0, 3, 1, 2), 2), 50, 3),
            roofline(2 * n * hs * ws * 32 * 5 // 4, n * hs * ws * 32,
                     F32_FLOP_PER_S))
        del x
        times[f"head_tail[K{K}@{n}x{hs // 2}x{ws // 2}]"] = time_head_tail(
            n, gen, packed_sig.maps, slabs, hs // 2, ws // 2)
        for name in (f"pool2x[max@{n}x{hs}x{ws}]",
                     f"head_tail[K{K}@{n}x{hs // 2}x{ws // 2}]"):
            say_timing(name, times[name])
    out.update(times=times, err=err, sep=sep, tile_sep=tile_sep,
               warp=(n, hs, ws))
    for name, t in timer.report().items():
        say(f"25 StepTimer {name} total_s, mean_s", (t["total_s"], t["mean_s"]))
    return out


# ---------------------------------------------------------------------------
# phase 26: data-parallel SFF training on DDP (ranks on the one card)
# ---------------------------------------------------------------------------

# Bounds fixed before the first card reading: a rank's averaged gradient
# against the one-process step's on the global batch (of each tensor's
# max, phase 9's bound), the DDP mains' loss.txt against the one-process
# mains' (relative), and the NCCL world-1 step against the plain step (of
# each tensor's max). Every rank runs on cuda:0 under gloo: NCCL cannot
# run two ranks on one card.
DDP_GRAD_BOUND, DDP_LOSS_RTOL, NCCL_GRAD_BOUND = 1e-4, 1e-4, 1e-6
DDP_STEPS, DDP_TREE_ROWS, DDP_TIMEOUT_S = 3, 8, 300
# The ReLU guard (ROADMAP §3, "ReLU kinks"): cuDNN picks other float32
# algorithms for 16 rows than for 32, so the two forwards round apart and a
# ReLU input within that rounding of 0 can take the other side (91 of
# rank 0's inputs in the first card run). The guard holds the two forwards
# within DDP_RELU_REL_DIFF of each input's max |value| and allows a flip
# only where the input lies within the forwards' own difference of 0.
DDP_RELU_REL_DIFF = 1e-4
# Against the one-process gradient of one 32-row pass such flips move a
# gradient by up to the kinks' scale (ROADMAP §3: 2e-3 of a tensor's max);
# DDP_GRAD_BOUND holds against the same gradient taken in two 16-row
# halves, whose forwards are the ranks'.
DDP_KINK_GRAD_BOUND = 2e-3


def relu_sign_check(model, x, rows, rank, world):
    """This rank's forward of ``model`` on its ``rows`` against its rows of
    the forward on the global batch ``x``, ReLU input by ReLU input: the
    inputs of another sign, those of them farther from 0 than the two
    forwards' largest difference on that input (a flip that rounding
    cannot explain), and that difference's largest ratio to the input's
    max |value| over the layers."""
    from sstem_tpu_torch.parallel import ddp

    want = []
    out = {"flips": 0, "beyond_rounding": 0, "worst_rel_diff": 0.0}

    def keep(m, i, o):
        want.append(ddp.rank_rows(i[0], rank, world).clone())

    def compare(m, i, o):
        a, b = i[0], want.pop(0)
        d = (a - b).abs().max()
        flip = (a > 0) != (b > 0)
        out["flips"] += int(flip.sum())
        out["beyond_rounding"] += int((flip & (b.abs() > d)).sum())
        out["worst_rel_diff"] = max(out["worst_rel_diff"], float(
            d / b.abs().max().clamp_min(1e-30)))

    for hook, inputs in ((keep, x), (compare, rows)):
        handles = [m.register_forward_hook(hook) for m in model.modules()
                   if isinstance(m, torch.nn.ReLU)]
        try:
            with torch.no_grad():
                model(inputs)
        finally:
            for h in handles:
                h.remove()
    assert not want
    return out


def ddp_interp_rank(rank, world, device, cfg_path, ref_path, timed=10):
    """Phase 26a on one rank: ``train_interp.build`` under the group (IFNet
    in DDP) on this rank's rows of the reference's global batch. The ReLU
    sign check against the one-process forward of the whole batch, then
    DDP_STEPS steps with every kernel's count from 0 and the signatures
    recorded, step 1's averaged gradient against the one-process
    gradients of the same global batch (in two accumulated halves, and
    whole; the worst error over the tensors, of each tensor's max), the
    parameters after the steps against rank 0's (bitwise), then ``timed``
    steps on the host clock (the DDP_STEPS steps warm them)."""
    import torch.distributed as dist

    from sstem_tpu_torch import config
    from sstem_tpu_torch.cli import train_interp
    from sstem_tpu_torch.compat.config import load_sff_config
    from sstem_tpu_torch.parallel import ddp
    from sstem_tpu_torch.train.trainer import TrainState

    config.disable_tf32()
    ref = torch.load(ref_path, map_location=device, weights_only=True)
    model, opt, step, _, _, _ = train_interp.build(load_sff_config(cfg_path),
                                                   device, seed=SEED)
    bare = ddp.unwrap(model)
    rows = ddp.rank_rows((ref["x"], ref["y"]), rank, world)
    out = {"relu": relu_sign_check(bare, ref["x"], rows[0], rank, world)}
    wrappers = counted_kernels()
    for fn in wrappers.values():
        fn.launches = 0
    state = TrainState(model, opt)
    with KernelSignatures() as sig:
        state, metrics = step(state, rows)
        for key in ("halves", "whole"):
            worst = (0.0, "")
            for name, p in bare.named_parameters():
                want = ref[key][name]
                err = float((p.grad - want).abs().max()
                            / want.abs().max().clamp_min(1e-30))
                worst = max(worst, (err, name))
            out[f"worst_grad_{key}"] = worst
        out["loss"] = float(metrics["loss"])
        for _ in range(DDP_STEPS - 1):
            state, _ = step(state, rows)
        torch.cuda.synchronize()
    out.update(maps=dict(sig.maps),
               launches={k: f.launches for k, f in wrappers.items()})
    flat = torch.cat([p.detach().flatten() for p in bare.parameters()])
    lead = flat.clone()
    dist.broadcast(lead, 0)
    out["equal"] = torch.equal(lead, flat)
    del ref, flat, lead
    times = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, rows)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out.update(ms=times, peak_GiB=torch.cuda.max_memory_allocated() / 2 ** 30)
    return out


def interp_reference(root, timed=10):
    """Phase 26a's one-process side: the config, and in ``root`` the seeded
    global batch (TRAIN_BATCH x TRAIN_PATCH^2) with the one-process
    gradients of ``train_interp.build``'s net on it, taken twice: in two
    accumulated halves of 16 rows, which run the ranks' cuDNN algorithms
    (every ReLU input takes the rank's side), and whole, whose 32-row
    algorithms round apart and flip ReLU inputs within that rounding of 0
    (relu_sign_check). Then the one-process step itself (its loss) and
    its time: median of ``timed`` after DDP_STEPS warm steps. Returns
    (config path, reference path, loss, ms per step)."""
    from sstem_tpu_torch.cli import train_interp
    from sstem_tpu_torch.compat.config import load_sff_config
    from sstem_tpu_torch.train.trainer import TrainState

    cfg_path = write_interp_config(root, os.path.join(root, "unused"))
    g = torch.Generator().manual_seed(SEED)
    x = torch.rand(TRAIN_BATCH, 6, TRAIN_PATCH, TRAIN_PATCH, generator=g)
    y = torch.rand(TRAIN_BATCH, 1, TRAIN_PATCH, TRAIN_PATCH, generator=g)
    model, opt, step, _, _, criterion = train_interp.build(
        load_sff_config(cfg_path), DEV, seed=SEED)
    batch = (x.to(DEV), y.to(DEV))
    ref = {"x": x, "y": y}
    for key, parts in (("halves", DDP_WORLD), ("whole", 1)):
        model.zero_grad(set_to_none=True)
        for xp, yp in zip(*(t.chunk(parts) for t in batch)):
            (criterion(model(xp), yp) / parts).backward()
        ref[key] = {k: p.grad.cpu() for k, p in model.named_parameters()}
    ref_path = os.path.join(root, "interp_ref.pt")
    torch.save(ref, ref_path)
    state = TrainState(model, opt)
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    times = []
    for i in range(DDP_STEPS - 1 + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        if i >= DDP_STEPS - 1:
            times.append((time.perf_counter() - t0) * 1e3)
    return cfg_path, ref_path, loss, times


def check_interp_ranks(ranks, one_loss, one_ms):
    """Phase 26a's checks on the ranks' results; prints the ms/step of DDP
    beside the one process's. Returns the ranks' sepconv launches (summed)
    for the JSON line."""
    label = f"26a ddp train_interp {DDP_WORLD}x{TRAIN_BATCH // DDP_WORLD}"
    launches = {"sepconv_fwd": 0, "sepconv_bwd": 0}
    for rank, r in enumerate(ranks):
        relu = r["relu"]
        say(f"{label} rank {rank} ReLU inputs of another sign than the "
            "one-process forward's: all, beyond the two forwards' "
            "difference", [relu["flips"], relu["beyond_rounding"]])
        say(f"{label} rank {rank} ReLU inputs' largest difference / their "
            "max |value|", relu["worst_rel_diff"])
        assert relu["beyond_rounding"] == 0, (rank, relu)
        assert relu["worst_rel_diff"] <= DDP_RELU_REL_DIFF, (rank, relu)
        say(f"{label} rank {rank} step-1 worst grad err / max|grad| vs one "
            "process in two 16-row halves", r["worst_grad_halves"])
        assert r["worst_grad_halves"][0] <= DDP_GRAD_BOUND, (rank, r)
        say(f"{label} rank {rank} step-1 worst grad err / max|grad| vs one "
            "process in one 32-row pass", r["worst_grad_whole"])
        assert r["worst_grad_whole"][0] <= DDP_KINK_GRAD_BOUND, (rank, r)
        say(f"{label} rank {rank} step-1 loss (mean over ranks) vs one "
            "process", [r["loss"], one_loss])
        assert abs(r["loss"] - one_loss) <= 1e-5 * abs(one_loss), rank
        say(f"{label} rank {rank} parameters after {DDP_STEPS} steps equal "
            "rank 0's", r["equal"])
        assert r["equal"], rank
        fired = {k: n for k, n in r["launches"].items() if n}
        say(f"{label} rank {rank} launches in {DDP_STEPS} steps", fired)
        assert fired == {"sepconv_fwd": 2 * DDP_STEPS,
                         "sepconv_bwd": 2 * DDP_STEPS}, (rank, fired)
        assert set(r["maps"]) == {("sepconv", *DDP_INTERP_SIG),
                                  ("sepconv_bwd", *DDP_INTERP_SIG)}, r["maps"]
        assert set(r["maps"]) <= MAP_CHECKS
        for k in launches:
            launches[k] += fired[k]
        say(f"{label} rank {rank} peak_memory_GiB", r["peak_GiB"])
    ms_ddp, ms_one = statistics.median(ranks[0]["ms"]), statistics.median(one_ms)
    timed = len(one_ms)
    say(f"{label} ms_per_step (median of {timed} after {DDP_STEPS} warm; both "
        "ranks share the card)", ms_ddp)
    say(f"{label} ms_per_step runs", ranks[0]["ms"])
    say(f"26a one-process train_interp {TRAIN_BATCH} ms_per_step (median of "
        f"{timed} after {DDP_STEPS} warm)", ms_one)
    say("26a one-process train_interp ms_per_step runs", one_ms)
    say("26a ddp / one-process ms_per_step", ms_ddp / ms_one)
    return launches


@contextlib.contextmanager
def raw_crops_one_thread():
    """The trainers' --device-datagen path as a process group runs it: raw
    crops from the host (no pool) with one provider thread, so that a
    one-process run draws the global batches that the ranks split."""
    from sstem_tpu_torch.cli import train_unfolding
    from sstem_tpu_torch.data import providers

    saved = train_unfolding.Provider, providers.RawCropPairDataset.load_pool
    train_unfolding.Provider = functools.partial(providers.Provider,
                                                 num_threads=1)
    providers.RawCropPairDataset.load_pool = lambda self, max_bytes=0: None
    try:
        yield
    finally:
        train_unfolding.Provider, providers.RawCropPairDataset.load_pool = saved


def ddp_mains_rank(rank, world, device, cfg_u, cfg_f):
    """Phase 26b on one rank: ``train_unfolding.main`` then
    ``train_fusion.main`` with --device-datagen under the group (one
    provider thread), each with every kernel's count from 0 and the
    signatures recorded."""
    from sstem_tpu_torch.cli import train_fusion, train_unfolding
    from sstem_tpu_torch.data import providers

    train_unfolding.Provider = functools.partial(providers.Provider,
                                                 num_threads=1)
    wrappers = counted_kernels()
    out = {}
    for name, main, cfg in (("unfolding", train_unfolding.main, cfg_u),
                            ("fusion", train_fusion.main, cfg_f)):
        for fn in wrappers.values():
            fn.launches = 0
        with KernelSignatures() as sig:
            paths = main(["-c", cfg, "--max-iters", str(DDP_STEPS),
                          "--device-datagen", "--device", device.type])
            torch.cuda.synchronize()
        out[name] = {"paths": paths, "warps": dict(sig.warps),
                     "launches": {k: f.launches for k, f in wrappers.items()
                                  if f.launches}}
    return out


def loss_lines(paths):
    with open(os.path.join(paths["cache_path"], "loss.txt")) as f:
        lines = f.read().splitlines()
    return [float(ln.split("loss = ")[1].split()[0]) for ln in lines]


def mains_reference(root):
    """Phase 26b's one-process side: a seeded tree of DDP_TREE_ROWS
    triplets of TRAININGSET_SIZE^2 (the clean middle sections stand in for
    interp images), the configs at bench.py:394-399's workload (a loss
    line a step), and ``train_unfolding.main`` then ``train_fusion.main``
    (behind that unfolding run's checkpoint) with --device-datagen, on
    raw crops with one provider thread. Returns (the DDP runs' config
    paths, the one-process runs' paths)."""
    from sstem_tpu_torch.cli import train_fusion, train_unfolding
    from sstem_tpu_torch.data import write_triplet_tree

    data = os.path.join(root, "data")
    rows = write_triplet_tree(data, n_triplets=DDP_TREE_ROWS,
                              size=TRAININGSET_SIZE, seed=SEED)
    with open(os.path.join(data, "interp_train_data.txt"), "w") as f:
        f.write("\n".join(r.split()[1] for r in rows) + "\n")
    every = {"display_freq": 1}
    cfg = {name: write_sff_train_config(root, data, name, every)
           for name in ("unfold_one", "unfold_ddp")}
    argv = ["--max-iters", str(DDP_STEPS), "--device-datagen", "--device",
            torch.device(DEV).type]
    with raw_crops_one_thread():
        one_u = train_unfolding.main(["-c", cfg["unfold_one"]] + argv)
        fusion = {**every, "output_nc": 1, "flownet_path": one_u["save_path"],
                  "flownet_id": "model-%06d.ckpt" % DDP_STEPS}
        for name in ("fusion_one", "fusion_ddp"):
            cfg[name] = write_sff_train_config(root, data, name, fusion)
        one_f = train_fusion.main(["-c", cfg["fusion_one"]] + argv)
    return (cfg["unfold_ddp"], cfg["fusion_ddp"]), {"unfolding": one_u,
                                                    "fusion": one_f}


def check_mains_ranks(ranks, one):
    """Phase 26b's checks: rank 0's loss.txt against the one-process run's
    within DDP_LOSS_RTOL, the checkpoints' keys equal, one run directory, a
    warp a fusion step a rank at DDP_WARP. Returns the ranks' warp
    launches (summed) for the JSON line."""
    warps = 0
    for name in ("unfolding", "fusion"):
        label = f"26b ddp train_{name} {DDP_WORLD}x{SFF_TRAIN_BATCH // DDP_WORLD}"
        paths = ranks[0][name]["paths"]
        assert ranks[1][name]["paths"] == paths
        got, want = loss_lines(paths), loss_lines(one[name])
        say(f"{label} rank 0 loss.txt vs one process", [got, want])
        assert len(got) == len(want) == DDP_STEPS, (got, want)
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        say(f"{label} loss.txt worst relative difference", rel)
        assert rel <= DDP_LOSS_RTOL, (name, rel)
        keys = [list(torch.load(os.path.join(p["save_path"], "model-%06d.ckpt"
                                             % DDP_STEPS), map_location="cpu",
                                weights_only=True)["model_weights"])
                for p in (paths, one[name])]
        assert keys[0] == keys[1], name
        say(f"{label} checkpoint keys equal the one-process run's "
            "(no module. prefix)", len(keys[0]))
        for rank, r in enumerate(ranks):
            run = r[name]
            say(f"{label} rank {rank} launches", run["launches"])
            if name == "fusion":
                assert run["launches"] == {"warp_bilinear": DDP_STEPS}, run
                assert run["warps"] == {DDP_WARP: DDP_STEPS}, run["warps"]
                warps += DDP_STEPS
            else:
                assert run["launches"] == {} and not run["warps"], run
    return warps


def ddp_rank(rank, world, device, interp, mains):
    """Phase 26a and 26b on one rank of one group."""
    out = {"interp": ddp_interp_rank(rank, world, device, *interp)}
    torch.cuda.empty_cache()
    out["mains"] = ddp_mains_rank(rank, world, device, *mains)
    return out


def nccl_rank(rank, world, device, batch, hw):
    """Phase 26c: one train_interp step (IFNet K=51, L1) of the net in DDP
    under NCCL at world 1 against the same step of a bare copy. Returns
    the backend, both losses and the worst gradient error (of each
    tensor's max)."""
    import copy

    import torch.distributed as dist

    from sstem_tpu_torch import config
    from sstem_tpu_torch.cli import _sff, train_interp
    from sstem_tpu_torch.dryrun import dryrun_config
    from sstem_tpu_torch.train.trainer import TrainState, make_optimizer

    config.disable_tf32()
    cfg = dryrun_config(batch)
    cfg.TRAIN["kernel_size"] = K
    bare, opt, step, _, sched, _ = train_interp.build(cfg, device, seed=SEED,
                                                      data_parallel=False)
    twin = copy.deepcopy(bare)
    wrapped = _sff.data_parallel(twin, batch, device)
    g = torch.Generator().manual_seed(SEED)
    xy = (torch.rand(batch, 6, hw, hw, generator=g).to(device),
          torch.rand(batch, 1, hw, hw, generator=g).to(device))
    losses = []
    for model, o in ((wrapped, make_optimizer(twin.parameters(), sched)),
                     (bare, opt)):
        _, metrics = step(TrainState(model, o), xy)
        losses.append(float(metrics["loss"]))
    twins = dict(twin.named_parameters())
    worst = max((float((twins[k].grad - p.grad).abs().max()
                       / p.grad.abs().max().clamp_min(1e-30)), k)
                for k, p in bare.named_parameters())
    return {"backend": dist.get_backend(), "type": type(wrapped).__name__,
            "losses": losses, "worst": worst}


def ddp_phase(gen):
    """Phase 26: data-parallel SFF training on DDP, every rank on cuda:0
    under gloo (the card's machine has one card). (a) and (b) in one
    2-rank group: the interp trainer at full width against the one-process
    step, and the correction and fusion trainers' mains against the
    one-process mains. Then (c) a DDP step under NCCL at world 1 against
    the plain step, in a group of its own while (d) dryrun_multichip(2)
    and dryrun.entry() run (neither is timed). Returns the launches for
    the JSON line."""
    from concurrent.futures import ThreadPoolExecutor

    from sstem_tpu_torch import dryrun
    from sstem_tpu_torch.parallel import launch

    root = os.path.join(OUT, "ddp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out = {}
    t0 = time.perf_counter()
    cfg_path, ref_path, one_loss, one_ms = interp_reference(root)
    torch.cuda.empty_cache()
    mains_cfgs, one_mains = mains_reference(root)
    torch.cuda.empty_cache()
    say("26a-b one-process side seconds", time.perf_counter() - t0)
    t1 = time.perf_counter()
    ranks = launch.spawn(ddp_rank, DDP_WORLD, (cfg_path, ref_path),
                         mains_cfgs, device=DEV, backend="gloo",
                         timeout_s=DDP_TIMEOUT_S)
    say("26a-b ranks seconds", time.perf_counter() - t1)
    out["interp"] = check_interp_ranks([r["interp"] for r in ranks], one_loss,
                                       one_ms)
    out["fusion_warps"] = check_mains_ranks([r["mains"] for r in ranks],
                                            one_mains)
    t1 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        nccl = pool.submit(launch.spawn, nccl_rank, 1, 2, 64, device=DEV,
                           backend="nccl", timeout_s=DDP_TIMEOUT_S)
        loss = dryrun.dryrun_multichip(DDP_WORLD, device=DEV)
        say("26d dryrun_multichip(2) loss", loss)
        fn, args = dryrun.entry(device=DEV)
        y = fn(*args)
        torch.cuda.synchronize()
        say("26d entry() output shape, finite",
            [tuple(y.shape), bool(torch.isfinite(y).all())])
        assert y.shape == (1, 1, 256, 256) and bool(torch.isfinite(y).all())
        (r,) = nccl.result()
    say("26c backend, wrapper", [r["backend"], r["type"]])
    assert r["backend"] == "nccl" and r["type"] == "DistributedDataParallel"
    say("26c DDP step vs plain step losses", r["losses"])
    say("26c DDP step vs plain step worst grad err / max|grad|", r["worst"])
    assert r["worst"][0] <= NCCL_GRAD_BOUND, r["worst"]
    say("26c-d seconds", time.perf_counter() - t1)
    return out


# ---------------------------------------------------------------------------
# phase 27: the matmul-precision policy and the self-trained quality tools
# ---------------------------------------------------------------------------

PRECISIONS = ("highest", "high", "default")
POLICY_STEPS, POLICY_WARM = 5, 2

# 27c's workloads: the quality tools at full width (K=51, ngf 32, the
# tools' default batches, crops and eval sections) and a short horizon
QUALITY_ITERS = 20
QUALITY_ARGS = ["--device-datagen", "--triplets", "16", "--img-size", "384",
                "--iters", str(QUALITY_ITERS)]
QUALITY_SP_ITERS = (20, 10, 12)  # vfi, denoise, fusion
QUALITY_SP_ARGS = ["--quartets", "8", "--img-size", "320",
                   "--eval-quartets", "2", "--eval-size", "512",
                   "--iters-vfi", str(QUALITY_SP_ITERS[0]),
                   "--iters-denoise", str(QUALITY_SP_ITERS[1]),
                   "--iters-fusion", str(QUALITY_SP_ITERS[2])]
QUALITY_STACK, QUALITY_CHECK_SIZE = 768, 512


def fresh_process_script(gpu, cli_argv, out_dir, cpu_npz):
    """27a's subprocess: a fresh interpreter, torch's own flags (cuDNN TF32
    on), both TF32 flags raised before each entry point; the card's restore
    against the CPU's in ``cpu_npz``; prints one JSON line."""
    root = os.path.dirname(os.path.abspath(__file__))
    return f"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
import chip_smoke as cs
from sstem_tpu_torch import config
from sstem_tpu_torch.cli import infer_interp
from sstem_tpu_torch.data import synth_stack

cs.GPU = {gpu!r}
def flags():
    return [torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32]
def tf32_on():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
out = {{"torch_defaults": flags()}}
small = synth_stack(5, 150, 170, seed=0)
tf32_on()
pipe = cs.build_pipeline("cuda", config.PARITY_DTYPE)
out["after_pipeline"] = flags()
gpu = pipe.restore_stack_scanned(small, [1, 3])
saved = np.load({cpu_npz!r})
cpu = {{i: {{k: saved[f"{{i}}/{{k}}"] for k in gpu[i]}} for i in (1, 3)}}
cs.compare_pipelines(gpu, cpu, [1, 3])
tf32_on()
forced = pipe.restore_stack_scanned(small, [1, 3])
def levels(a):
    return max(int(np.abs(a[i][k].astype(np.int32)
                          - cpu[i][k].astype(np.int32)).max())
               for i in (1, 3) for k in ("interp", "fused", "warped"))
out["level_diff_policy"] = levels(gpu)
out["level_diff_tf32_on"] = levels(forced)
tf32_on()
infer_interp.main({cli_argv!r} + ["-op", {out_dir!r}])
out["after_infer_interp"] = flags()
print(json.dumps(out))
"""


def fresh_process_phase(root, cpu_out=None):
    """27a: the fault repaired, in a process started from torch's defaults:
    ``SFFPipeline(dtype=PARITY_DTYPE)`` and ``infer_interp.main`` on the
    card leave both TF32 flags False; phase 5's restore card vs CPU
    (``cpu_out``, phase 5's CPU side; made here when None) within phase 5's
    bounds, and its largest uint8 level difference beside the same restore
    with TF32 forced on. ``infer_interp`` runs on phase 20's case where it
    exists."""
    from sstem_tpu_torch import config
    from sstem_tpu_torch.data import synth_stack

    case = os.path.join(OUT, "sff_cli")
    if os.path.exists(os.path.join(case, "interp.pth")):
        argv = ["-c", os.path.join(case, "cfg.yaml"), "-ip",
                os.path.join(case, "data"), "-t", "sff", "-m", "valid"]
    else:
        argv = write_cli_case(case)
    argv += ["--ckpt", os.path.join(case, "interp.pth")]
    os.makedirs(root, exist_ok=True)
    if cpu_out is None:
        cpu_out = build_pipeline("cpu", config.PARITY_DTYPE) \
            .restore_stack_scanned(synth_stack(5, 150, 170, seed=0), [1, 3])
    cpu_npz = os.path.join(root, "phase5_cpu.npz")
    np.savez(cpu_npz, **{f"{i}/{k}": v for i, out in cpu_out.items()
                         for k, v in out.items()})
    script = fresh_process_script(GPU, argv, os.path.join(root, "out"),
                                  cpu_npz)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=600)
    print(proc.stdout[-4000:], end="", flush=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    say("27a fresh process seconds", time.perf_counter() - t0)
    say("27a torch's own flags (cudnn, matmul TF32)", res["torch_defaults"])
    for key in ("after_pipeline", "after_infer_interp"):
        say(f"27a TF32 flags {key}", res[key])
        assert res[key] == [False, False], (key, res[key])
    say("27a restore card vs cpu max level diff, policy applied (bound 1)",
        res["level_diff_policy"])
    say("27a restore card vs cpu max level diff, TF32 forced on",
        res["level_diff_tf32_on"])
    assert res["level_diff_policy"] <= 1, res
    return res


def policy_phase(root):
    """27b: ``train_interp.build``'s step at phase 10's workload (IFNet
    K=51, 32 x 256^2 from the seed, L1, AdamW) under each precision: the
    loss and gradients of step 1 (the worst |g - g_highest| / max
    |g_highest| over the tensors), then the step timed (median of
    POLICY_STEPS after POLICY_WARM), sepconv 2 + 2 a step asserted and the
    signatures checked. Informative times, no bound; ``default`` must
    change the gradients."""
    from sstem_tpu_torch import config
    from sstem_tpu_torch.cli import train_interp
    from sstem_tpu_torch.compat.config import load_sff_config
    from sstem_tpu_torch.kernels import sepconv_planar, sepconv_planar_bwd
    from sstem_tpu_torch.train.trainer import TrainState

    cfg = load_sff_config(write_interp_config(root, os.path.join(root, "x")))
    g = torch.Generator().manual_seed(SEED)
    batch = (torch.rand(TRAIN_BATCH, 6, TRAIN_PATCH, TRAIN_PATCH,
                        generator=g).to(DEV),
             torch.rand(TRAIN_BATCH, 1, TRAIN_PATCH, TRAIN_PATCH,
                        generator=g).to(DEV))
    grads, out = {}, {}
    try:
        for name in PRECISIONS:
            config.set_matmul_precision(name)
            model, opt, step, _, _, criterion = train_interp.build(
                cfg, DEV, seed=SEED)
            loss = criterion(model(batch[0]), batch[1])
            loss.backward()
            grads[name] = {k: p.grad.clone() for k, p in
                           model.named_parameters()}
            model.zero_grad(set_to_none=True)
            worst = max(float((grads[name][k] - ref).abs().max()
                              / ref.abs().max().clamp_min(1e-30))
                        for k, ref in grads["highest"].items())
            state = TrainState(model, opt)
            for _ in range(POLICY_WARM):
                state, _ = step(state, batch)
            torch.cuda.synchronize()
            sepconv_planar.launches = sepconv_planar_bwd.launches = 0
            times = []
            with KernelSignatures() as sig:
                for _ in range(POLICY_STEPS):
                    t0 = time.perf_counter()
                    state, metrics = step(state, batch)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
            report_signatures(f"27b {name} step", sig, POLICY_STEPS, "step")
            assert sepconv_planar.launches == 2 * POLICY_STEPS
            assert sepconv_planar_bwd.launches == 2 * POLICY_STEPS
            ms = statistics.median(times)
            out[name] = {"loss": float(loss), "worst_grad": worst, "ms": ms}
            say(f"27b {name} step-1 loss", float(loss))
            say(f"27b {name} worst grad err vs highest / max|grad|", worst)
            say(f"27b {name} ms/step (median of {POLICY_STEPS} after "
                f"{POLICY_WARM} warm)", ms)
            say(f"27b {name} ms/step runs", times)
            assert np.isfinite(float(metrics["loss"]))
            del model, opt, step, state
    finally:
        config.disable_tf32()
    assert out["default"]["worst_grad"] > 1e-4, out["default"]
    return out


def tool_run(label, main, argv):
    """One quality tool's ``main(argv)`` on the card with every kernel's
    count from 0 and the signatures recorded (checked against the lists).
    Returns (its result, {kernel: launches}, the signatures, seconds)."""
    wrappers = counted_kernels()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with KernelSignatures() as sig:
        result = main(argv)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    say(f"27c {label} seconds", seconds)
    for k, n in launches.items():
        say(f"27c {label} {k} launches", n)
    report_signatures(f"27c {label}", sig, 1, "run",
                      check_channels(SFF_CONV_CHECKS)
                      | check_channels(DECONV_CHECKS, "deconv2x"))
    return result, launches, sig, seconds


def quality_tools_phase(root):
    """27c: quality_run (--device-datagen), quality_run_sp, quality_check
    (--packed-conv, on the SFF run's checkpoints) and diagnose_fusion (on
    its root) at full width and a short horizon: every stage.json key, every
    report row finite, the launches (sepconv forward and backward in the
    interp steps, a warp a fusion step, conv3x3, pool and deconv in the
    bf16 column) and the signatures. The bf16 deltas are printed, not
    gated: at this horizon they mean nothing."""
    from sstem_tpu_torch.tools import (
        diagnose_fusion, quality_check, quality_run, quality_run_sp,
    )

    f32 = ("float32", "float32")
    bf16 = ("bfloat16", "bfloat16")
    group = PATH_LAUNCHES["packed"]
    res = {}
    sff = os.path.join(root, "sff")
    results, launches, sig, _ = tool_run(
        "quality_run", quality_run.main, ["--root", sff] + QUALITY_ARGS)
    with open(os.path.join(sff, "stage.json")) as f:
        stage = json.load(f)
    assert sorted(stage) == ["cfg_i", "fusion_save", "interp_save",
                             "interp_ts", "unfold_save"], stage
    for mode, rows in results.items():
        for key, (p, s) in rows.items():
            say(f"27c quality_run {mode} {key} PSNR, SSIM", [p, s])
            assert np.isfinite([p, s]).all(), (mode, key)
    with open(os.path.join(sff, "SCORES.md")) as f:
        text = f.read()
    print(text, flush=True)
    assert all(f"| {key} |" in text for key in quality_run.ROWS)
    n = QUALITY_ITERS
    interp = (4, 1, 256, 256, K) + f32
    assert sig.maps[("sepconv",) + interp] == 2 * n, sig.maps
    assert sig.maps[("sepconv_bwd",) + interp] == 2 * n, sig.maps
    assert sig.warps[(16, 256, 256)] == n, sig.warps
    assert sig.warps[(3, QUALITY_STACK, QUALITY_STACK)] == 2, sig.warps
    for kernel in ("conv3x3_fused", "pool2x", "deconv2x_fused"):
        assert launches[kernel] == group[kernel], (kernel, launches)
    res["quality_run"] = launches

    sp = os.path.join(root, "sp")
    rows, launches, sig, _ = tool_run(
        "quality_run_sp", quality_run_sp.main, ["--root", sp] + QUALITY_SP_ARGS)
    with open(os.path.join(sp, "stage.json")) as f:
        assert sorted(json.load(f)) == ["data", "denoise_save", "eval_data",
                                        "fusion_save", "vfi_save"]
    for key, (p, s) in rows.items():
        say(f"27c quality_run_sp {key} PSNR, SSIM", [p, s])
        assert np.isfinite([p, s]).all(), key
    with open(os.path.join(sp, "SCORES_SP.md")) as f:
        print(f.read(), flush=True)
    vfi = (8, 1, 128, 128, K) + f32
    steps = QUALITY_SP_ITERS[0] + QUALITY_SP_ITERS[2]
    assert sig.maps[("sepconv_bwd",) + vfi] == 4 * steps, sig.maps
    assert launches["sepconv_bwd"] == 4 * steps, launches
    res["quality_run_sp"] = launches

    rows, launches, sig, _ = tool_run(
        "quality_check", quality_check.main,
        ["--interp", stage["interp_save"], "--flow", stage["unfold_save"],
         "--fusion", stage["fusion_save"], "--packed-conv"])
    for key, (diff, psnr) in rows.items():
        say(f"27c quality_check {key} max level diff, PSNR f32 vs bf16",
            [diff, psnr])
        assert np.isfinite(psnr), key
    for kernel in ("conv3x3_fused", "pool2x", "deconv2x_fused"):
        assert launches[kernel] == group[kernel], (kernel, launches)
    assert launches["sepconv_fwd"] == 4 and launches["warp_bilinear"] == 2
    res["quality_check"] = launches

    report, launches, sig, _ = tool_run(
        "diagnose_fusion", diagnose_fusion.main,
        ["--root", sff, "--out", os.path.join(root, "diag.json")])
    for name, row in report["psnr"].items():
        say(f"27c diagnose_fusion PSNR {name}", row)
    for name, row in report["epe"].items():
        say(f"27c diagnose_fusion EPE {name}", row)
        assert np.isfinite(list(row.values())).all(), name
    say("27c diagnose_fusion fusion curve", report["curve"])
    say("27c diagnose_fusion unfolding curve", report["curve_unfold"])
    assert report["curve"] and report["curve_unfold"]
    assert launches["sepconv_fwd"] == 2, launches
    return res


def precision_phase(gen, cpu_out=None):
    """Phase 27: the fault (27a; ``cpu_out``: phase 5's CPU restore), the
    three policies (27b), the quality tools (27c), then the kernels at the
    shapes this phase adds beside their plain versions and bounds."""
    import torch.nn.functional as F

    from sstem_tpu_torch.kernels import pool2x, pool2x_plain, serving_warp
    from sstem_tpu_torch.ops.warp import spatial_transform

    root = os.path.join(OUT, "precision")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out = {}
    for step, fn, args in (
            ("a", fresh_process_phase, (os.path.join(root, "a"), cpu_out)),
            ("b", policy_phase, (root,)),
            ("c", quality_tools_phase, (os.path.join(root, "q"),))):
        t0 = time.perf_counter()
        out[step] = fn(*args)
        say(f"27{step} seconds", time.perf_counter() - t0)

    t0 = time.perf_counter()
    times, err = {}, {}
    for sig in QUALITY_SEPCONV:
        times[("fwd", sig)] = time_sepconv(*sig, gen)
        say_timing(f"sepconv_fwd[{sig}]", times[("fwd", sig)])
    for sig in QUALITY_SEPCONV_BWD:
        times[("bwd", sig)] = time_sepconv_bwd(*sig, gen)
        say_timing(f"sepconv_bwd[{sig}]", times[("bwd", sig)])
    for shape in QUALITY_WARPS:
        im, flow = warp_inputs(*shape, gen)
        times[shape] = timing(
            cuda_ms(lambda: serving_warp(im, flow), reps=20),
            cuda_ms(lambda: spatial_transform(im, flow), reps=5), None,
            (shape[0] * shape[1] * shape[2] * (4 + 8 + 4)
             / HBM_BYTES_PER_S * 1e3, "bytes"))
        say_timing(f"warp_bilinear[{shape}]", times[shape])
    n, hw = 3, QUALITY_STACK
    conv_row, deconv_row = (n, hw, hw, 32, 32, None), (n, hw // 2, hw // 2,
                                                       64, 32, None)
    err["conv3x3_fused"] = check_conv(*conv_row[:5], "relu", None, gen)
    err["deconv2x_fused"] = check_deconv(*deconv_row[:5], "relu", None, gen)
    err["pool2x"] = check_pool(n, hw, hw, 32, "max", gen)
    times.update(time_conv_rows([conv_row], gen, {}, 1))
    times.update(time_deconv_rows([deconv_row], gen, {}, 1))
    x = randn((n, hw, hw, 32), gen)
    name = f"pool2x[max@{n}x{hw}x{hw}x32]"
    times[name] = timing(
        cuda_ms(lambda: pool2x(x, "max"), 50, 3),
        cuda_ms(lambda: pool2x_plain(x, "max"), 5),
        cuda_ms(lambda: F.max_pool2d(x.permute(0, 3, 1, 2), 2), 50, 3),
        roofline(2 * n * hw * hw * 32 * 5 // 4, n * hw * hw * 32 // 4 * 4,
                 F32_FLOP_PER_S))
    say_timing(name, times[name])
    say("27 kernel timing seconds", time.perf_counter() - t0)
    out["times"], out["err"] = times, err
    return out


def precision_kernel_entries(res, sep_err, bwd_err, warp_err):
    """JSON entries of phase 27: each kernel at the shapes the quality
    tools add, its launches over the tool run that launched it."""
    c = res["c"]
    fwd, bwd = ("sepconv_fwd.cu", "sstem_tpu/kernels/sepconv.py:240"), \
        ("sepconv_bwd.cu", "sstem_tpu/kernels/sepconv.py:287")
    warp = ("warp_bilinear.cu", "sstem_tpu/kernels/warp_band.py:64")
    entries = []
    for sig, tool in zip(QUALITY_SEPCONV, QUALITY_SEPCONV_TOOLS):
        entries.append((f"sepconv_fwd[{tool} {sig[0]}x1x{sig[2]}x{sig[3]} "
                        f"{dtype_short(sig[5])}]", *fwd,
                        c[tool]["sepconv_fwd"], sep_err[sig],
                        res["times"][("fwd", sig)]))
    for sig, tool in zip(QUALITY_SEPCONV_BWD, ("quality_run", "quality_run_sp")):
        entries.append((f"sepconv_bwd[{tool} {sig[0]}x1x{sig[2]}x{sig[3]} "
                        "f32]", *bwd, c[tool]["sepconv_bwd"], bwd_err[sig],
                        res["times"][("bwd", sig)]))
    for shape, tool in zip(QUALITY_WARPS, QUALITY_WARP_TOOLS):
        entries.append((f"warp_bilinear[{tool} %dx%dx%d]" % shape, *warp,
                        c[tool]["warp_bilinear"], warp_err[shape],
                        res["times"][shape]))
    for name, t in res["times"].items():
        if not isinstance(name, str):
            continue
        kernel = name.split("[")[0]
        source, replaces = {
            "conv3x3_fused": ("conv3x3_fused.cu", "sstem_tpu/kernels/conv3x3.py:124"),
            "deconv2x_fused": ("deconv2x_fused.cu", "sstem_tpu/kernels/deconv.py:63"),
            "pool2x": ("pool2x.cu", "sstem_tpu/kernels/pool.py:45"),
        }[kernel]
        entries.append((f"{kernel}[quality_run bf16 {name.split('[')[1]}",
                        source, replaces, c["quality_run"][kernel],
                        res["err"][kernel], t))
    return [{"name": name, "route": "cuda",
             "source": "sstem_tpu_torch/csrc/" + source, "replaces": replaces,
             "launches": launches, "max_abs_err": err,
             **{k: t[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                  "bound_by")}}
            for name, source, replaces, launches, err, t in entries]


# ---------------------------------------------------------------------------
# phase 28: the compute-dtype policy
# ---------------------------------------------------------------------------

# (matmul precision, compute dtype) of each timed training setting: float32
# at "highest" and at "default" (one bf16 pass, float32 out), and
# bench.py:109-111's "default" + "bfloat16" (bf16 activations over float32
# parameters)
DTYPE_SETTINGS = (("highest", None), ("default", None),
                  ("default", "bfloat16"))
DTYPE_STEPS, DTYPE_WARM, DTYPE_TRAJECTORY = 10, 3, 20
# 28b: the IFNet step card vs CPU under "default" + "bfloat16", held as
# tests/test_torch_compute_dtype.py holds the port's step to JAX's: the
# loss (relative), the whole gradient and each conv's (kernel and bias
# together; relative L2). A bf16 step's gradient is not defined per
# tensor: a first card reading held each tensor's NRMSE from the CPU's
# float32 gradient to twice the CPU bf16 step's plus 0.05, and the heads'
# conv3 biases (sums over every pixel whose terms cancel) read 0.63 on
# the card against 0.14 on the CPU; the CPU test reads 0.88 for JAX
# against 0.39 for the port. The loss and whole-gradient bounds were fixed
# before the first card reading, the per-conv bound before its first.
DTYPE_CHECK_BATCH, DTYPE_CHECK_HW = 2, 64
DTYPE_CHECK_BOUNDS = {"loss_rel": 1e-2, "grad_rel_l2": 0.1,
                      "conv_rel_l2": 0.5}
DTYPE_MAIN_STEPS = 3


def rel_l2(got, want, keys):
    """|got - want| / |want| over the tensors ``keys`` together."""
    diff = sum(float((got[k] - want[k]).double().square().sum()) for k in keys)
    norm = sum(float(want[k].double().square().sum()) for k in keys)
    return (diff / max(norm, 1e-300)) ** 0.5


def set_policy(precision, dtype):
    from sstem_tpu_torch import config

    config.set_matmul_precision(precision)
    config.set_compute_dtype(dtype)


def policy_label(precision, dtype):
    return precision + ("+bf16" if dtype else "")


def dtype_card_vs_cpu(seed=SEED, hw=DTYPE_CHECK_HW, batch=DTYPE_CHECK_BATCH):
    """28b: one L1 step of IFNet(51) at batch x hw^2 from the same seeded
    float32 weights and data: under "default" + "bfloat16" on the card and
    on the CPU, and in float32 at "highest" on the CPU. Holds the bf16
    prediction's dtype, the parameters' and gradients' float32, and the
    card against the CPU within DTYPE_CHECK_BOUNDS; prints each bf16
    side's distance from the float32 gradient."""
    import copy

    from sstem_tpu_torch import losses
    from sstem_tpu_torch.models import IFNet

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((batch, 6, hw, hw), dtype=np.float32))
    y = torch.from_numpy(rng.random((batch, 1, hw, hw), dtype=np.float32))
    base = IFNet(K, generator=torch.Generator().manual_seed(seed))
    runs = {}
    try:
        for label, dev, dtype in (("card", "cuda", "bfloat16"),
                                  ("cpu", "cpu", "bfloat16"),
                                  ("cpu_f32", "cpu", None)):
            set_policy("default" if dtype else "highest", dtype)
            model = copy.deepcopy(base).to(dev)
            pred = model(x.to(dev))
            assert pred.dtype == (torch.bfloat16 if dtype else torch.float32)
            loss = losses.l1_loss(pred, y.to(dev))
            assert loss.dtype == torch.float32
            loss.backward()
            grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
            assert {p.dtype for p in model.parameters()} == {torch.float32}
            assert {g.dtype for g in grads.values()} == {torch.float32}
            runs[label] = loss.item(), grads
    finally:
        set_policy("highest", None)
    (card_loss, card), (cpu_loss, cpu), (_, f32) = (
        runs[k] for k in ("card", "cpu", "cpu_f32"))
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    convs = {}
    for k in cpu:
        convs.setdefault(k.rsplit(".", 1)[0], []).append(k)
    say("28b loss card, cpu (default + bf16), cpu float32",
        [card_loss, cpu_loss, runs["cpu_f32"][0]])
    say("28b loss card vs cpu relative", loss_rel)
    out = {"loss_rel": loss_rel}
    for label, got, want in (("card vs cpu", card, cpu),
                             ("card vs cpu f32", card, f32),
                             ("cpu vs cpu f32", cpu, f32)):
        whole = rel_l2(got, want, list(want))
        per = {c: rel_l2(got, want, ks) for c, ks in convs.items()}
        worst = max(per, key=per.get)
        say(f"28b gradient {label} relative L2: whole, worst conv, median "
            "conv", f"{whole} {per[worst]} ({worst}) "
            f"{statistics.median(per.values())}")
        out[label] = (whole, per[worst], worst)
    grad_rel, conv_rel, worst = out["card vs cpu"]
    bounds = DTYPE_CHECK_BOUNDS
    assert loss_rel <= bounds["loss_rel"], loss_rel
    assert grad_rel <= bounds["grad_rel_l2"], grad_rel
    assert conv_rel <= bounds["conv_rel_l2"], (worst, conv_rel)
    return out


def loss_trajectory(label, build, next_batch, steps=DTYPE_TRAJECTORY):
    """``steps`` steps of a fresh ``build()`` (model, opt, step) from the
    seed, on ``next_batch()``'s seeded batches: the losses, finite,
    printed."""
    from sstem_tpu_torch.train.trainer import TrainState

    model, opt, step = build()
    state, out = TrainState(model, opt), []
    for _ in range(steps):
        state, metrics = step(state, next_batch())
        out.append(float(metrics["loss"]))
    say(f"{label} loss trajectory ({steps} steps from the seed)", out)
    assert all(np.isfinite(out)), (label, out)
    return out


def dtype_cells(root):
    """28c: bench.py's two training cells under each DTYPE_SETTINGS entry,
    in this call: the interp step (train_interp.build: IFNet K=51, 32 x
    256^2 from the seed, L1, AdamW; sepconv 2 + 2 a step asserted) and the
    unfolding step with device data generation (train_unfolding.build:
    FusionNet ngf 32, batch 8 of 400^2 crops from a uint8 pool on the card,
    degraded and cut to 256^2). Each: ms/step (median of DTYPE_STEPS after
    DTYPE_WARM), peak memory, 2 profiled steps (idle share, device ms by
    kind), then a DTYPE_TRAJECTORY-step loss trajectory from the seed."""
    from sstem_tpu_torch.cli import train_interp, train_unfolding
    from sstem_tpu_torch.compat.config import load_sff_config
    from sstem_tpu_torch.data import synth_stack
    from sstem_tpu_torch.train import device_datagen
    from sstem_tpu_torch.train.trainer import TrainState

    cfg_i = load_sff_config(write_interp_config(root, os.path.join(root, "x")))
    cfg_u = load_sff_config(write_sff_train_config(
        root, os.path.join(root, "x"), "unfold_28", {}))
    g = torch.Generator().manual_seed(SEED)
    batch = (torch.rand(TRAIN_BATCH, 6, TRAIN_PATCH, TRAIN_PATCH,
                        generator=g).to(DEV),
             torch.rand(TRAIN_BATCH, 1, TRAIN_PATCH, TRAIN_PATCH,
                        generator=g).to(DEV))
    # 16 (clean, interp) pairs of 512^2 from the seed
    pool = synth_stack(2 * TRAININGSET_ROWS, TRAININGSET_SIZE,
                       TRAININGSET_SIZE, seed=SEED).reshape(
        TRAININGSET_ROWS, 2, TRAININGSET_SIZE, TRAININGSET_SIZE)

    def interp_build():
        model, opt, step, _, _, _ = train_interp.build(cfg_i, DEV, seed=SEED)
        return model, opt, step

    def unfold_build():
        model, opt, _, _, _ = train_unfolding.build(cfg_u, DEV, SEED)
        base = device_datagen.make_device_datagen_loss(
            det_size=SFF_TRAIN_DET, seed=SEED)
        step = device_datagen.make_pool_step(
            base, pool, SFF_TRAIN_BATCH, SFF_TRAIN_CROP, DEV, seed=SEED)
        return model, opt, step

    def interp_batches():
        gen = torch.Generator(device=DEV).manual_seed(SEED)
        return lambda: (
            torch.rand(TRAIN_BATCH, 6, TRAIN_PATCH, TRAIN_PATCH, generator=gen,
                       device=DEV),
            torch.rand(TRAIN_BATCH, 1, TRAIN_PATCH, TRAIN_PATCH, generator=gen,
                       device=DEV))

    out = {}
    try:
        for cell, build, pixels, batches in (
                ("interp", interp_build, TRAIN_BATCH * TRAIN_PATCH ** 2,
                 lambda: (lambda: batch)),
                ("unfolding", unfold_build,
                 SFF_TRAIN_BATCH * SFF_TRAIN_DET ** 2,
                 lambda: device_datagen.CounterProvider().next)):
            for precision, dtype in DTYPE_SETTINGS:
                set_policy(precision, dtype)
                label = f"28c {cell} {policy_label(precision, dtype)}"
                model, opt, step = build()
                ms, per = time_train_step(label, step, TrainState(model, opt),
                                          batches(), timed=DTYPE_STEPS,
                                          warm=DTYPE_WARM, pixels=pixels)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                if cell == "interp":
                    assert per == {"sepconv_fwd": 2, "sepconv_bwd": 2}, per
                else:
                    assert not per, per
                assert {p.dtype for p in model.parameters()} == {torch.float32}
                del model, opt, step
                torch.cuda.empty_cache()
                traj = loss_trajectory(
                    label, build,
                    interp_batches() if cell == "interp" else batches())
                out[cell, precision, dtype] = {"ms": ms, "peak_GiB": peak,
                                               "trajectory": traj,
                                               "launches": per}
                torch.cuda.empty_cache()
            say(f"28c {cell} ms/step " + " / ".join(
                policy_label(*k) for k in DTYPE_SETTINGS),
                [out[cell, p, d]["ms"] for p, d in DTYPE_SETTINGS])
    finally:
        set_policy("highest", None)
    return out


def float32_only(payload):
    """(floating tensors, of them float32) in a checkpoint's payload."""
    tensors = []

    def walk(v):
        if torch.is_tensor(v):
            if v.is_floating_point():
                tensors.append(v)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)

    walk(payload)
    return len(tensors), sum(t.dtype == torch.float32 for t in tensors)


def checkpoints_float32(label, root):
    """Every model-*.ckpt under ``root`` holds float32 floating tensors
    only. Returns the number of checkpoints."""
    paths = [os.path.join(d, f) for d, _, files in os.walk(root)
             for f in files if f.startswith("model-") and f.endswith(".ckpt")]
    assert paths, (label, root)
    for path in paths:
        n, f32 = float32_only(torch.load(path, map_location="cpu",
                                         weights_only=True))
        assert n and f32 == n, (path, n, f32)
    say(f"{label} checkpoints, all float32", len(paths))
    return len(paths)


def dtype_mains(root):
    """28d: the six trainers' ``main`` for DTYPE_MAIN_STEPS steps each
    under "default" + "bfloat16", set as a caller sets the policy before
    an entry point, on trees of their own made from the seed: the SFF
    chain on a triplet tree of TRAININGSET_ROWS x TRAININGSET_SIZE^2
    (train_interp at phase 10's workload, infer_interp_trainingset -bs
    TRAININGSET_BS behind its checkpoint, train_unfolding and train_fusion
    with --device-datagen at bench.py:394-399's, the fusion run behind the
    unfolding run's checkpoint), then the three SP trainers on an
    SP_TRAIN_ROWS x SP_TRAIN_SIZE^2 quartet tree (the fusion run's vfi and
    denoise branches pretrained from the first two). Launches asserted,
    signatures checked (every sepconv bf16), checkpoints float32 only,
    and the caller's compute dtype and precision unchanged after each
    run. Returns each run's launches."""
    from sstem_tpu_torch import config
    from sstem_tpu_torch.cli import (
        infer_interp_trainingset, train_fusion, train_interp,
        train_sp_correction, train_sp_fusion, train_sp_interp, train_unfolding,
    )
    from sstem_tpu_torch.data import write_triplet_tree
    from sstem_tpu_torch.data.synthetic import write_quartet_tree

    steps, bf = DTYPE_MAIN_STEPS, ("bfloat16", "bfloat16")
    data = os.path.join(root, "sff_data")
    rows = write_triplet_tree(data, n_triplets=TRAININGSET_ROWS,
                              size=TRAININGSET_SIZE, seed=SEED)
    with open(os.path.join(data, "valid_data.txt"), "w") as f:
        f.write("\n".join(rows[:2]) + "\n")
    sp_data = os.path.join(root, "sp_data")
    sp_txt = write_quartet_tree(sp_data, SP_TRAIN_ROWS, SP_TRAIN_SIZE,
                                seed=SEED)
    fwd_i, fwd_sp = ("sepconv", *BF16_TRAIN_SIG), ("sepconv", *BF16_SP_TRAIN_SIG)
    bwd_i, bwd_sp = ("sepconv_bwd", *BF16_TRAIN_SIG), \
        ("sepconv_bwd", *BF16_SP_TRAIN_SIG)
    batches = -(-TRAININGSET_ROWS // TRAININGSET_BS)

    def latest(name, models=os.path.join(root, "models")):
        """The newest run directory of config ``name`` and its last
        checkpoint."""
        run = sorted(d for d in os.listdir(models) if d.endswith(name))[-1]
        ckpt = sorted(f for f in os.listdir(os.path.join(models, run))
                      if f.startswith("model-"))[-1]
        return os.path.join(models, run), ckpt

    launches = {}

    def run(name, main, argv, want, maps):
        _, sig = run_main(f"28d {name}", main, argv, want)
        assert set(sig.maps) == maps, (name, sig.maps)
        assert config.compute_dtype() is torch.bfloat16, name
        assert config.matmul_precision() == "default", name
        launches[name] = want

    try:
        set_policy("default", "bfloat16")
        # 2 a step, 2 for the step-1 preview's crop and 2 for each of the
        # two 512^2 validation images (phase 10)
        cfg_i = write_interp_config(root, data)
        run("train_interp", train_interp.main,
            ["-c", cfg_i, "--max-iters", str(steps)],
            {"sepconv_fwd": 2 * steps + 2 + 2 * 2, "sepconv_bwd": 2 * steps},
            {fwd_i, bwd_i,
             ("sepconv", 1, 1, TRAIN_PATCH, TRAIN_PATCH, K, *bf),
             ("sepconv", 1, 1, TRAININGSET_SIZE, TRAININGSET_SIZE, K, *bf)})
        interp_dir, interp_ckpt = latest("interp_k51_b32")
        cfg_t = os.path.join(root, "trainingset.yaml")
        with open(cfg_t, "w") as f:
            f.write(f"TRAIN:\n  kernel_size: {K}\nTEST:\n  pad: 0\n"
                    f"DATA:\n  folder_name: {data}\n"
                    "  train_txt: train_data.txt\n")
        run("infer_interp_trainingset", infer_interp_trainingset.main,
            ["-c", cfg_t, "--ckpt", os.path.join(interp_dir, interp_ckpt),
             "-bs", str(TRAININGSET_BS)],
            {"sepconv_fwd": 2 * batches},
            {("sepconv", TRAININGSET_BS, 1, TRAININGSET_SIZE,
              TRAININGSET_SIZE, K, *bf)})
        run("train_unfolding", train_unfolding.main,
            ["-c", write_sff_train_config(root, data, "unfold_28", {}),
             "--max-iters", str(steps), "--device-datagen"], {}, set())
        flow_dir, flow_ckpt = latest("unfold_28")
        # a warp a step
        run("train_fusion", train_fusion.main,
            ["-c", write_sff_train_config(
                root, data, "fusion_28",
                {"output_nc": 1, "flownet_path": flow_dir,
                 "flownet_id": flow_ckpt}),
             "--max-iters", str(steps), "--device-datagen"],
            {"warp_bilinear": steps}, set())
        # 4 forwards and 4 backwards a step, 4 forwards for the preview
        sp_want = {"sepconv_fwd": 4 * steps + 4, "sepconv_bwd": 4 * steps}
        run("train_sp_interp", train_sp_interp.main,
            ["-opt", write_sp_train_config(root, sp_data, sp_txt, "sp_interp",
                                           if_use_vfiImg=True),
             "--max-iters", str(steps)], sp_want, {fwd_sp, bwd_sp})
        run("train_sp_correction", train_sp_correction.main,
            ["-opt", write_sp_train_config(root, sp_data, sp_txt,
                                           "sp_correction"),
             "--max-iters", str(steps)], {}, set())
        pretrained = os.path.join(root, "sp_pretrained")
        os.makedirs(pretrained)
        os.symlink(run_dir(root, "sp_interp"), os.path.join(pretrained, "vfi"))
        os.symlink(run_dir(root, "sp_correction"),
                   os.path.join(pretrained, "denoise"))
        run("train_sp_fusion", train_sp_fusion.main,
            ["-opt", write_sp_train_config(
                root, sp_data, sp_txt, "sp_fusion", mode="b",
                vfi_lr_weight=1e-20, denoise_lr_weight=1e-6,
                if_pretrained=True, resume_path=pretrained,
                if_pretrained_vfi=True, if_pretrained_denoise=True,
                vfi_last_iter=steps, denoise_last_iter=steps),
             "--max-iters", str(steps)], sp_want, {fwd_sp, bwd_sp})
    finally:
        set_policy("highest", None)
    checkpoints_float32("28d", root)
    return launches


def dtype_phase(gen):
    """Phase 28: the bf16 training signatures' kernels timed (28a; phases
    3 and 8 held both designs against the plain versions), the step card
    vs CPU (28b), the two training cells under the three settings (28c),
    the six trainers' mains under the policy (28d)."""
    root = os.path.join(OUT, "compute_dtype")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out = {"times": {}}
    t0 = time.perf_counter()
    for sig in (BF16_TRAIN_SIG, BF16_SP_TRAIN_SIG):
        n, hw = sig[0], sig[2]
        out["times"][("fwd", sig)] = time_sepconv(*sig, gen, reps=20)
        out["times"][("bwd", sig)] = time_sepconv_bwd(*sig, gen)
        for kernel in ("fwd", "bwd"):
            say_timing(f"sepconv_{kernel}[bf16 train {n}x1x{hw}^2]",
                       out["times"][(kernel, sig)])
    say("28a seconds", time.perf_counter() - t0)
    os.makedirs(os.path.join(root, "mains"))
    for step, fn, args in (("b", dtype_card_vs_cpu, ()),
                           ("c", dtype_cells, (root,)),
                           ("d", dtype_mains, (os.path.join(root, "mains"),))):
        t0 = time.perf_counter()
        out[step] = fn(*args)
        say(f"28{step} seconds", time.perf_counter() - t0)
    return out


# ---------------------------------------------------------------------------
# phase 29: the on-card tools and the batched head tail
# ---------------------------------------------------------------------------

# each profiler at its tool's default full-width shapes, with fewer calls
# than the tool's own (the phase's time)
PROFILER_CALLS = {"profile_pipeline": dict(iters=3, warm=2),
                  "profile_serve": dict(iters=3, warm=2),
                  "profile_fine": dict(iters=3, warm=2),
                  "ifnet_prefix_bench": dict(iters=3, warm=1),
                  "micro_conv_bench": dict(iters=3, warm=2),
                  "bench_conv3x3": dict(iters=5, warm=3)}
# the batched tail's path beside the two it joins, in one call
TAIL_PATHS = (("packed", {}), ("packed_fused_tail", {"fused_head_tail": True}),
              ("packed_batched_tail", {"batched_head_tail": True}))


def tools_phase():
    """Phase 29: (a) ``gpu_checks.run_checks()`` (every case printed, all
    ok asserted, GPU_CHECKS.json under build/chip_smoke/, each counted
    kernel launched); (b) each profiler's function at its tool's
    full-width shapes (PROFILER_CALLS); (c) the packed restore with
    ``batched_head_tail=True`` card vs CPU at phase 13's bounds, then at
    phase 14's workload beside the unfused and fused tails (launches per
    group asserted, ms/section); (d) ``verify_drive.main`` in process, exit
    0 asserted. Returns the batched path's launches by kernel."""
    import importlib

    from sstem_tpu_torch import config
    from sstem_tpu_torch.data import synth_stack
    from sstem_tpu_torch.tools import gpu_checks, verify_drive

    phase("29a gpu_checks: the kernels against their plain versions at the "
          "JAX tool's cases")
    t0 = time.perf_counter()
    wrappers = counted_kernels()
    for fn in wrappers.values():
        fn.launches = 0
    res = gpu_checks.run_checks()
    for name, case in res.items():
        if isinstance(case, dict):
            say(f"29a gpu_checks {name} max_abs_err (tol {case['tol']}, "
                f"ok {case['ok']})", case["max_abs_err"])
    say("29a gpu_checks all_ok", res["all_ok"])
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "GPU_CHECKS.json"), "w") as f:
        json.dump(res, f, indent=1)
    for kernel, fn in wrappers.items():
        say(f"29a gpu_checks {kernel} launches", fn.launches)
        assert fn.launches > 0, f"gpu_checks launched no {kernel}"
    assert res["all_ok"], [k for k, v in res.items()
                           if isinstance(v, dict) and not v["ok"]]
    say("29a seconds", time.perf_counter() - t0)

    phase("29b the profilers at their full-width shapes")
    for tool, kwargs in PROFILER_CALLS.items():
        t0 = time.perf_counter()
        module = importlib.import_module(f"sstem_tpu_torch.tools.{tool}")
        rows = getattr(module, tool)(**kwargs)
        for row, value in rows.items():
            for key, v in (value.items() if isinstance(value, dict)
                           else (("ms", value),)):
                assert np.isfinite(v), (tool, row, key, v)
                say(f"29b {tool} {row.strip()} {key}", v)
        say(f"29b {tool} seconds", time.perf_counter() - t0)

    phase("29c the batched head tail: packed card vs cpu (K=51, bfloat16, "
          "150 x 170), then 25 x 1250^2, 12 sections, chunk 4, beside the "
          "unfused and fused tails")
    bf16 = config.SERVING_DTYPE
    small = synth_stack(5, 150, 170, seed=0)
    x3 = group_input(small, [1, 3])
    secs, outs = [], []
    for dev in (DEV, "cpu"):
        pipe = build_pipeline(dev, bf16, packed_conv=True,
                              batched_head_tail=True)
        secs.append(pipe.section(x3.to(dev)))
        outs.append(pipe.restore_stack_scanned(small, [1, 3]))
    compare_packed(secs[0], secs[1], outs[0], outs[1], [1, 3])
    del pipe, secs, outs
    stack = synth_stack(25, 1250, 1250, seed=0)
    ids = list(range(1, 24, 2))
    runs = {path: full_size_run(stack, ids, bf16, path, packed_conv=True,
                                **options)
            for path, options in TAIL_PATHS}
    for path, (_, ms, _) in runs.items():
        say(f"29c full bfloat16 {path} ms_per_section, this phase", ms)
    del stack

    phase("29d verify_drive")
    t0 = time.perf_counter()
    assert verify_drive.main([]) == 0, "VERIFY FAIL"
    say("29d seconds", time.perf_counter() - t0)
    return runs["packed_batched_tail"][0]


def batched_kernel_entries(launches, packed, times, sep_err, warp_err):
    """JSON entries of phase 29's batched-tail path: its conv3x3, deconv and
    pool at phase 15's timed shapes (the packed path's signatures, which
    this path launches too), its sepconv at phase 7's 4 x 1 x 1280^2 bf16
    and its warp at 4 x 1280^2; launches are the kernel's in the path's
    checked run."""
    entries = []
    for kernel, source, replaces, _ in NEW_KERNELS:
        for name, t in packed["times"].items():
            if name.split("[")[0] == kernel and launches[kernel]:
                entries.append({
                    "name": name.replace("[", "[batched tail ", 1),
                    "route": "cuda", "source": source, "replaces": replaces,
                    "launches": launches[kernel],
                    "max_abs_err": packed["err"][kernel], **t})
    bf16_sig = (4, 1, 1280, 1280, K, "bfloat16", "bfloat16")
    entries.append({
        "name": "sepconv_fwd[batched tail 4x1x1280^2 bf16]", "route": "cuda",
        "source": "sstem_tpu_torch/csrc/sepconv_fwd.cu",
        "replaces": "sstem_tpu/kernels/sepconv.py:240",
        "launches": launches["sepconv_fwd"], "max_abs_err": sep_err[bf16_sig],
        **times["sepconv_bf16"]})
    ms, plain = times["warp"]
    entries.append({
        "name": "warp_bilinear[batched tail 4x1280x1280]", "route": "cuda",
        "source": "sstem_tpu_torch/csrc/warp_bilinear.cu",
        "replaces": "sstem_tpu/kernels/warp_band.py:64",
        "launches": launches["warp_bilinear"],
        "max_abs_err": warp_err[(4, 1280, 1280)], "ms": ms, "plain_ms": plain,
        "bound_ms": 4 * 1280 * 1280 * (4 + 8 + 4) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None})
    return entries


def dtype_kernel_entries(res, sep_err, bwd_err):
    """JSON entries of phase 28: both sepconv kernels at the bf16 training
    signatures, their launches over the trainers' main runs (28d)."""
    entries = []
    for sig, runs in ((BF16_TRAIN_SIG, ("train_interp",)),
                      (BF16_SP_TRAIN_SIG, ("train_sp_interp",
                                           "train_sp_fusion"))):
        for kernel, err in (("fwd", sep_err), ("bwd", bwd_err)):
            entries.append({
                "name": f"sepconv_{kernel}[bf16 policy {'+'.join(runs)} "
                        f"{sig[0]}x1x{sig[2]}x{sig[3]}]",
                "route": "cuda",
                "source": f"sstem_tpu_torch/csrc/sepconv_{kernel}.cu",
                "replaces": ("sstem_tpu/kernels/sepconv.py:240" if kernel == "fwd"
                             else "sstem_tpu/kernels/sepconv.py:287"),
                "launches": sum(res["d"][r][f"sepconv_{kernel}"] for r in runs),
                "max_abs_err": err[sig], **res["times"][(kernel, sig)]})
    return entries


def dtype_short(name):
    return {"float32": "f32", "bfloat16": "bf16"}[name]


def sharded_kernel_entries(res, sep_err, warp_err, head_tail_err):
    """JSON entries of phase 25: the kernels at the sharded restore's slab
    shapes (1 x 1408 x 1280; the deconv and head tail on its half
    resolution) and the sepconv and warp at the tiled restore's; launches
    are each kernel's over phase 25's sharded runs, or its tiled runs."""
    t = res["times"]
    sharded, tiled = res["sharded"], res["tiled"]
    n, hs, ws = res["warp"]
    src = "sstem_tpu_torch/csrc/"
    entries = [
        ("sepconv_fwd", f"sepconv_fwd[restore_stack_sharded {n}x1x{hs}x{ws} "
         "bf16]", "sepconv_fwd.cu", "sstem_tpu/kernels/sepconv.py:240",
         sharded, sep_err[res["sep"]], t["sepconv"]),
        ("warp_bilinear", f"warp_bilinear[restore_stack_sharded {n}x{hs}x{ws}]",
         "warp_bilinear.cu", "sstem_tpu/kernels/warp_band.py:64", sharded,
         warp_err[(n, hs, ws)], t[(n, hs, ws)]),
        ("sepconv_fwd", "sepconv_fwd[infer_tiled 4x1x640^2 f32]",
         "sepconv_fwd.cu", "sstem_tpu/kernels/sepconv.py:240", tiled,
         sep_err[res["tile_sep"]], t["sepconv_tiled"]),
        ("warp_bilinear", "warp_bilinear[infer_tiled 4x640x640]",
         "warp_bilinear.cu", "sstem_tpu/kernels/warp_band.py:64", tiled,
         warp_err[(4, 640, 640)], t[(4, 640, 640)]),
    ]
    for name, timed in t.items():
        if not isinstance(name, str) or "[" not in name:
            continue
        kernel = name.split("[")[0]
        source, replaces = {
            "conv3x3_fused": ("conv3x3_fused.cu", "sstem_tpu/kernels/conv3x3.py:124"),
            "deconv2x_fused": ("deconv2x_fused.cu", "sstem_tpu/kernels/deconv.py:63"),
            "pool2x": ("pool2x.cu", "sstem_tpu/kernels/pool.py:45"),
            "head_tail": ("head_tail.cu", "sstem_tpu/kernels/head_tail.py:174"),
        }[kernel]
        err = head_tail_err if kernel == "head_tail" else res["err"][kernel]
        entries.append((kernel, f"{kernel}[restore_stack_sharded "
                        f"{name.split('[')[1]}", source, replaces, sharded,
                        err, timed))
    return [{"name": name, "route": "cuda", "source": src + source,
             "replaces": replaces, "launches": launches[kernel],
             "max_abs_err": err, **timed}
            for kernel, name, source, replaces, launches, err, timed in entries]


SP_KERNELS = (
    # JSON name prefix, source, TPU kernel body, where its launches come from
    ("conv3x3_fused[probe", "sstem_tpu_torch/csrc/conv3x3_fused.cu",
     "tools/probe_dma_conv.py:84", "probe_launches"),
    ("conv3x3_fused", "sstem_tpu_torch/csrc/conv3x3_fused.cu",
     "sstem_tpu/kernels/conv3x3.py:124", "sp_launches"),
    ("pool2x", "sstem_tpu_torch/csrc/pool2x.cu",
     "sstem_tpu/kernels/pool.py:45", "sp_launches"),
    ("head_tail", "sstem_tpu_torch/csrc/head_tail.cu",
     "sstem_tpu/kernels/head_tail.py:174", "sp_launches"),
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
    the kernel's in the SP served path's run with fused head tails (phase
    18) or in the probes' run (phase 19a), all shapes together."""
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
    conv3x3 narrow_in and narrow_out, head-tail wgmma, sepconv forward and
    backward blocked) from the build's
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
            ni = re.search(r"conv3x3_narrow_in_kernelILi(\d+)ELi(\d+)", line)
            no = re.search(r"conv3x3_narrow_out_kernelILi(\d+)E", line)
            b = re.search(r"sepconv_(fwd|bwd)_blocked_kernelILi(\d+)E"
                          r"(?:Li(\d+)E)?(\w+?)EEv", line)
            if m:
                name = f"{m.group(1)} wgmma Cin_p={m.group(2)} N={m.group(3)}"
            elif ni:
                name = f"conv3x3 narrow_in K_p={ni.group(1)} N={ni.group(2)}"
            elif no:
                name = f"conv3x3 narrow_out Cin_p={no.group(1)} N=24"
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
    # the simulators lean on cv2; make_validset's HDF5 sidecars on h5py
    for module in ("cv2", "h5py"):
        print(f"{module} installed:", importlib.util.find_spec(module) is not None,
              flush=True)

    from sstem_tpu_torch import config
    from sstem_tpu_torch.data import synth_stack
    from sstem_tpu_torch.kernels import _build, serving_warp
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

    phase("4 warp kernel vs plain, every WARP_CHECKS shape")
    warp_cases = {c: warp_inputs(*c, gen) for c in WARP_CHECKS}
    warp_err = {c: check_warp(*warp_cases[c], "paths") for c in WARP_CHECKS}
    im, fold = warp_cases[(4, 1280, 1280)]
    far = (rand((4, 1280, 1280, 2), gen) - 0.5) * (6 * 1280)
    warp_err[(4, 1280, 1280)] = max(warp_err[(4, 1280, 1280)],
                                    check_warp(im, far, "far-out-of-range"))

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
    bwd_err = {c: check_sepconv_bwd(*c, gen) for c in SEPCONV_BWD_CHECKS[1:]}

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

    phase(f"20 the SFF inference CLIs at {CLI_SIZE}^2")
    sff_cli_phase()

    phase("21 SFF correction and fusion training at full width: FusionNet "
          f"ngf 32, batch {SFF_TRAIN_BATCH}, {SFF_TRAIN_CROP}^2 crops to "
          f"{SFF_TRAIN_DET}^2, L1, AdamW, float32 (bench.py:394-399)")
    train21 = sff_training_phase(os.path.join(OUT, "sff_cli", "interp.pth"))

    phase(f"22 infer_unfolding and infer_interp_single at {CLI_SIZE}^2")
    cli22 = sff_serving_cli_phase()

    phase("21-22 the kernels at the new paths' shapes (CUDA events)")
    for shape in ((SFF_TRAIN_BATCH, SFF_TRAIN_DET, SFF_TRAIN_DET),
                  (1, CLI_SIZE, CLI_SIZE)):
        im_s, flow_s = warp_cases[shape]
        times[shape] = timing(
            cuda_ms(lambda: serving_warp(im_s, flow_s), reps=20),
            cuda_ms(lambda: spatial_transform(im_s, flow_s), reps=5), None,
            (shape[0] * shape[1] * shape[2] * (4 + 8 + 4) / HBM_BYTES_PER_S
             * 1e3, "bytes"))
        say_timing(f"warp_bilinear[{shape[0]}x{shape[1]}x{shape[2]}]",
                   times[shape])
    new_sepconv = {"trainingset": (TRAININGSET_BS, 1, TRAININGSET_SIZE,
                                   TRAININGSET_SIZE, K, "float32", "float32"),
                   "interp_single": (1, 1, 1280, 1280, K, "float32", "float32")}
    for name, sig in new_sepconv.items():
        times[name] = time_sepconv(*sig, gen)
        say_timing(f"sepconv_fwd[{name} {sig[0]}x1x{sig[2]}^2 f32]",
                   times[name])

    phase("23 SP training at full width: train_sp_interp, train_sp_correction "
          f"and train_sp_fusion, IFNet K={K}, {SP_TRAIN_PATCH}^2 crops, batch "
          f"{SP_TRAIN_BATCH}, Adam, float32 (the JAX trainers' defaults)")
    train23 = sp_training_phase()
    phase("23 the sepconv kernels at the SP trainers' signature (CUDA events)")
    times["sp_train_fwd"] = time_sepconv(*SP_TRAIN_SIG, gen, reps=20)
    times["sp_train_bwd"] = time_sepconv_bwd(*SP_TRAIN_SIG, gen)
    for kernel in ("fwd", "bwd"):
        say_timing(f"sepconv_{kernel}[sp train {SP_TRAIN_BATCH}x1x"
                   f"{SP_TRAIN_PATCH}^2 f32]", times[f"sp_train_{kernel}"])

    phase("24 the data tools and the perceptual loss: simulate_sff, "
          "simulate_sp, gen_data_txt, train_sp_correction and "
          "train_unfolding on their data, train_interp perceptual (K="
          f"{K}, {TRAIN_BATCH} x {TRAIN_PATCH}^2), losses card vs cpu")
    tools24 = data_tools_phase()
    preview = (1, SFF_TRAIN_DET, SFF_TRAIN_DET)
    im_s, flow_s = warp_cases[preview]
    times[preview] = timing(
        cuda_ms(lambda: serving_warp(im_s, flow_s), reps=20),
        cuda_ms(lambda: spatial_transform(im_s, flow_s), reps=5), None,
        (SFF_TRAIN_DET ** 2 * (4 + 8 + 4) / HBM_BYTES_PER_S * 1e3, "bytes"))
    say_timing(f"warp_bilinear[preview 1x{SFF_TRAIN_DET}x{SFF_TRAIN_DET}]",
               times[preview])

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
        "max_abs_err": warp_err[(4, 1280, 1280)], "ms": times["warp"][0],
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
    # the slice's paths: the fusion trainer's warp (its main runs), the
    # unfolding CLI's, the two interp CLIs' sepconvs and train_interp
    # --device-datagen's sepconvs (the training signature, timed in phase 11)
    for shape, path, n_launches in (
            ((SFF_TRAIN_BATCH, SFF_TRAIN_DET, SFF_TRAIN_DET), "fusion_step",
             train21["fusion_main"]),
            ((1, CLI_SIZE, CLI_SIZE), "infer_unfolding",
             cli22["unfolding_warps"])):
        kernels.append({
            "name": f"warp_bilinear[{path} {shape[0]}x{shape[1]}x{shape[2]}]",
            "route": "cuda", "source": "sstem_tpu_torch/csrc/warp_bilinear.cu",
            "replaces": "sstem_tpu/kernels/warp_band.py:64",
            "launches": n_launches, "max_abs_err": warp_err[shape],
            **times[shape]})
    for name, n_launches in (("trainingset", train21["trainingset"]),
                             ("interp_single", cli22["single_sepconvs"])):
        kernels.append({
            "name": f"sepconv_fwd[{name}]", "route": "cuda",
            "source": "sstem_tpu_torch/csrc/sepconv_fwd.cu",
            "replaces": "sstem_tpu/kernels/sepconv.py:240",
            "launches": n_launches, "max_abs_err": sep_err[new_sepconv[name]],
            **times[name]})
    devgen = train21["interp_devgen"]
    for kernel, err, t in (("fwd", fwd_train_err, times["sepconv_fwd_train"]),
                           ("bwd", bwd_train_err, times["sepconv_bwd"])):
        kernels.append({
            "name": f"sepconv_{kernel}[train_interp device_datagen]",
            "route": "cuda", "source": f"sstem_tpu_torch/csrc/sepconv_{kernel}.cu",
            "replaces": ("sstem_tpu/kernels/sepconv.py:240" if kernel == "fwd"
                         else "sstem_tpu/kernels/sepconv.py:287"),
            "launches": devgen[f"sepconv_{kernel}"], "max_abs_err": err, **t})
    # the SP trainers' sepconvs (their main runs' launches)
    for trainer in ("interp", "fusion"):
        for kernel, err in (("fwd", sep_err[SP_TRAIN_SIG]),
                            ("bwd", bwd_err[SP_TRAIN_SIG])):
            kernels.append({
                "name": f"sepconv_{kernel}[train_sp_{trainer}]", "route": "cuda",
                "source": f"sstem_tpu_torch/csrc/sepconv_{kernel}.cu",
                "replaces": ("sstem_tpu/kernels/sepconv.py:240" if kernel == "fwd"
                             else "sstem_tpu/kernels/sepconv.py:287"),
                "launches": train23[trainer][f"sepconv_{kernel}"],
                "max_abs_err": err, **times[f"sp_train_{kernel}"]})
    # phase 24: train_interp's perceptual run (the training signature, timed
    # in phase 11) and the unfolding run's preview on the simulated tree
    for kernel, err, t in (("fwd", fwd_train_err, times["sepconv_fwd_train"]),
                           ("bwd", bwd_train_err, times["sepconv_bwd"])):
        kernels.append({
            "name": f"sepconv_{kernel}[train_interp perceptual]",
            "route": "cuda", "source": f"sstem_tpu_torch/csrc/sepconv_{kernel}.cu",
            "replaces": ("sstem_tpu/kernels/sepconv.py:240" if kernel == "fwd"
                         else "sstem_tpu/kernels/sepconv.py:287"),
            "launches": tools24["perceptual"][f"sepconv_{kernel}"],
            "max_abs_err": err, **t})
    kernels.append({
        "name": f"warp_bilinear[train_unfolding preview 1x{SFF_TRAIN_DET}x"
                f"{SFF_TRAIN_DET}]",
        "route": "cuda", "source": "sstem_tpu_torch/csrc/warp_bilinear.cu",
        "replaces": "sstem_tpu/kernels/warp_band.py:64",
        "launches": tools24["unfolding_warps"], "max_abs_err": warp_err[preview],
        **times[preview]})
    phase(f"25 the sharded stack restore (dp 2, dp 2 x sp 2, halo "
          f"{SHARDED_HALO}) and tiled inference ({TILE}+{TILE_HALO}) on one "
          "card's repeated mesh, the debug tools")
    t25 = time.perf_counter()
    sharded = sharded_phase(gen)
    say("25 phase seconds", time.perf_counter() - t25)

    phase(f"26 data-parallel SFF training on DDP: {DDP_WORLD} ranks on "
          "cuda:0 under gloo (train_interp at full width, train_unfolding and "
          "train_fusion main), a DDP step under NCCL at world 1, "
          "dryrun_multichip(2) and dryrun.entry()")
    t26 = time.perf_counter()
    ddp = ddp_phase(gen)
    say("26 phase seconds", time.perf_counter() - t26)
    phase("26 the kernels at a data-parallel rank's shapes (CUDA events)")
    times["ddp_fwd"] = time_sepconv(*DDP_INTERP_SIG, gen, reps=20)
    times["ddp_bwd"] = time_sepconv_bwd(*DDP_INTERP_SIG, gen)
    n, hw = DDP_INTERP_SIG[0], DDP_INTERP_SIG[2]
    for kernel in ("fwd", "bwd"):
        say_timing(f"sepconv_{kernel}[ddp train_interp {n}x1x{hw}^2 f32]",
                   times[f"ddp_{kernel}"])
        kernels.append({
            "name": f"sepconv_{kernel}[ddp train_interp {n}x1x{hw}^2 f32]",
            "route": "cuda", "source": f"sstem_tpu_torch/csrc/sepconv_{kernel}.cu",
            "replaces": ("sstem_tpu/kernels/sepconv.py:240" if kernel == "fwd"
                         else "sstem_tpu/kernels/sepconv.py:287"),
            "launches": ddp["interp"][f"sepconv_{kernel}"],
            "max_abs_err": (sep_err if kernel == "fwd" else bwd_err)[
                DDP_INTERP_SIG], **times[f"ddp_{kernel}"]})
    im_s, flow_s = warp_cases[DDP_WARP]
    times[DDP_WARP] = timing(
        cuda_ms(lambda: serving_warp(im_s, flow_s), reps=20),
        cuda_ms(lambda: spatial_transform(im_s, flow_s), reps=5), None,
        (DDP_WARP[0] * DDP_WARP[1] * DDP_WARP[2] * (4 + 8 + 4)
         / HBM_BYTES_PER_S * 1e3, "bytes"))
    name = "warp_bilinear[ddp train_fusion %dx%dx%d]" % DDP_WARP
    say_timing(name, times[DDP_WARP])
    kernels.append({
        "name": name, "route": "cuda",
        "source": "sstem_tpu_torch/csrc/warp_bilinear.cu",
        "replaces": "sstem_tpu/kernels/warp_band.py:64",
        "launches": ddp["fusion_warps"], "max_abs_err": warp_err[DDP_WARP],
        **times[DDP_WARP]})

    phase("27 the matmul-precision policy and the quality tools: a fresh "
          "process (SFFPipeline, infer_interp), train_interp's step under "
          "highest / high / default, quality_run, quality_run_sp, "
          "quality_check and diagnose_fusion at full width")
    t27 = time.perf_counter()
    precision = precision_phase(gen, cpu_out)
    say("27 phase seconds", time.perf_counter() - t27)
    kernels += precision_kernel_entries(precision, sep_err, bwd_err, warp_err)

    phase("28 the compute-dtype policy (config.set_compute_dtype): the "
          "sepconv kernels at the bf16 training signatures, the IFNet step "
          "card vs cpu under default + bfloat16, bench.py's interp and "
          "unfolding cells under highest / default / default + bfloat16, "
          "the six trainers' mains under the policy")
    t28 = time.perf_counter()
    dtype = dtype_phase(gen)
    say("28 phase seconds", time.perf_counter() - t28)
    kernels += dtype_kernel_entries(dtype, sep_err, bwd_err)

    phase("29 the on-card tools (gpu_checks, the six profilers, verify_drive) "
          "and the batched head tail")
    t29 = time.perf_counter()
    batched = tools_phase()
    say("29 phase seconds", time.perf_counter() - t29)
    kernels += batched_kernel_entries(batched, packed, times, sep_err,
                                      warp_err)

    kernels += new_kernel_entries(packed)
    kernels += sharded_kernel_entries(sharded, sep_err, warp_err,
                                      packed["err"]["head_tail"])
    sp["err"]["sepconv_fwd[sp"] = sep_err[(SP_BATCH, 1, 1280, 1280, K,
                                           "bfloat16", "bfloat16")]
    sp["err"]["head_tail"] = packed["err"]["head_tail"]
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
