#!/usr/bin/env python3
"""Smoke run of the sstem_tpu_torch port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device: a CUDA card is required; prints nvidia-smi's name and power limit
  2. build: compiles sstem_tpu_torch/csrc/*.cu with nvcc (prints ptxas output
     and the build seconds)
  3. sepconv kernel vs its plain PyTorch version on the same inputs
  4. warp kernel vs its plain PyTorch version on the same inputs
  5. pipeline on the card vs on the CPU (K=51, float32, TF32 off)
  6. full size: restore_stack_scanned on a 25 x 1250^2 stack, 12 damaged
     sections, chunk 4, K=51, ngf=32, in bfloat16 and in float32, with the
     kernels' launch counts, ms/section and peak memory
  7. kernel times beside their plain versions' (CUDA events)
  8. sepconv backward kernel vs its plain PyTorch version on the same inputs
  9. one IFNet training step on the card vs on the CPU (K=51, 64^2, float32,
     TF32 off): loss and every parameter's gradient
 10. full width training: ``train_interp.main`` for a few steps on the interp
     trainer's workload (IFNet K=51, 256^2 crops, batch 32, L1, AdamW wd 1e-4
     under the poly warmup/decay LR, float32 with TF32 off, a synthetic
     triplet tree of 16 x 320^2 made from the seed), then the step of
     ``build(cfg)`` timed: ms/step, steps/s, MP/s, peak memory, and the
     sepconv launches per step, and 2 steps under torch.profiler (device
     busy time, idle share, device time by kernel kind)
 11. sepconv forward and backward kernels vs their plain versions at the
     training shape, and their times (CUDA events)
 12. conv3x3, pool, deconv and head-tail kernels vs their plain versions at
     the packed_conv=True path's shapes (and an odd size for the edges)
 13. the packed_conv=True pipeline on the card vs on the CPU (K=51, bfloat16
     on both sides): NRMSE of each float output, uint8 level differences
 14. phase 6's workload in bfloat16 on the packed_conv=True path, with the
     head tails on cuDNN and on the head-tail kernel, beside the cuDNN path:
     launch counts per group asserted, ms/section, peak memory, and one call
     under torch.profiler each
 15. the new kernels at their full-width shapes (CUDA events) beside their
     plain versions, their bounds and one library call for the same work

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


def check_sepconv(n, c, h, w, k, image_dtype, maps_dtype, gen):
    """Kernel vs plain on the same unit-range image and maps whose taps sum
    to about 1 per pixel. Returns the max abs error."""
    from sstem_tpu_torch.kernels import sepconv_planar, sepconv_planar_plain

    image = rand((n, c, h + k - 1, w + k - 1), gen, dtype=image_dtype)
    vert = rand((n, k, h, w), gen, 2.0 / k, maps_dtype)
    horz = rand((n, k, h, w), gen, 2.0 / k, maps_dtype)
    got = sepconv_planar(image, vert, horz)
    want = sepconv_planar_plain(image, vert, horz)
    label = f"sepconv {n}x{c}x{h}x{w} K={k} image={image_dtype} maps={maps_dtype}"
    return assert_sepconv_close(label, got, want, (n, c, h, w))


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


def fold_flows(n, h, w, seed):
    """(n, h, w, 2) ground-truth unfolding flows of random fold lines."""
    from sstem_tpu_torch.ops.flow import gen_flow_np, gen_line

    rng = np.random.default_rng(seed)
    flows = []
    for _ in range(n):
        k, b = gen_line((rng.uniform(0, h), 0.0), (rng.uniform(0, h), w - 1.0))
        flows.append(gen_flow_np(h, w, k, b, line_width=8, fold_width=40)[1])
    return torch.from_numpy(np.stack(flows)).cuda()


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
    launch counts during one restore_stack_scanned call, ms/section); with
    ``profile``, one more call runs under torch.profiler."""
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
    out = pipe.restore_stack_scanned(stack, ids, chunk=chunk)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    del pipe.section
    say(f"full {name} groups", groups)
    for k, n in launches.items():
        say(f"full {name} {k} launches (per group)", f"{n} ({n / groups})")
    want = {k: PATH_LAUNCHES[path].get(k, 0) * groups for k in wrappers}
    assert launches == want, (launches, want)
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
    return launches, ms


def check_sepconv_bwd(n, c, h, w, k, maps_dtype, gen):
    """Backward kernel vs plain on the same unit-range image, maps whose
    taps sum to about 1 per pixel, and a zero-mean output gradient, in the
    float32 image dtype of training. Returns the max abs error."""
    from sstem_tpu_torch.kernels import sepconv_planar_bwd, sepconv_planar_bwd_plain

    image = rand((n, c, h + k - 1, w + k - 1), gen)
    vert = rand((n, k, h, w), gen, 2.0 / k, maps_dtype)
    horz = rand((n, k, h, w), gen, 2.0 / k, maps_dtype)
    grad = rand((n, c, h, w), gen) - 0.5
    got = sepconv_planar_bwd(image, vert, horz, grad)
    want = sepconv_planar_bwd_plain(image, vert, horz, grad)
    label = f"sepconv_bwd {n}x{c}x{h}x{w} K={k} maps={maps_dtype}"
    return assert_sepconv_bwd_close(label, got, want, (n, k, h, w))


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
    ("conv3x3_fused", "conv3x3 kernel"), ("deconv2x_fused", "deconv kernel"),
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
    os.makedirs(OUT, exist_ok=True)
    trace = os.path.join(OUT, trace_name)
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        work = [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X" and e.get("cat") in DEVICE_WORK]
    assert work, "the trace holds no device work"
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
    for _ in range(timed):
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
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


def check_head_tail(n, hi, wi, cx, k, gen):
    """Within 2e-2 of the max |value| (the hardware gate's tolerance,
    TPU_CHECKS.json head_tail_fused_640_k51): the kernel and F.interpolate
    may round an upsampled value to different bf16 neighbours."""
    from sstem_tpu_torch.kernels import head_tail, head_tail_plain

    x, w3, b3 = head_tail_inputs(n, hi, wi, cx, k, gen)
    got = head_tail(x, w3, b3)
    want = head_tail_plain(x, w3, b3)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (n, k, 2 * hi, 2 * wi)
    err = (got.float() - want.float()).abs()
    rel = float(err.max()) / float(want.float().abs().max())
    label = f"head_tail {n}x{hi}x{wi}x{cx} K={k}"
    say(f"{label} max_abs_err", float(err.max()))
    say(f"{label} max_err / max|value|", rel)
    say(f"{label} share of outputs off by more than 1 bf16 ulp", float(
        (err > bf16_ulp(torch.maximum(got.float().abs(), want.float().abs())))
        .float().mean()))
    assert rel <= 2e-2, f"{label}: kernel disagrees with the plain version"
    return float(err.max())


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


def time_new_kernels(gen):
    """Each new kernel at its full-width shapes: kernel, plain version and
    one library call for the same work, by CUDA events. Returns
    {name: (ms, plain_ms, library_ms, bound_ms, bound_by)}."""
    import torch.nn.functional as F

    from sstem_tpu_torch.kernels import (
        conv3x3_fused, conv3x3_fused_plain, deconv2x_fused,
        deconv2x_fused_plain, head_tail, head_tail_plain, pool2x,
        pool2x_plain)

    out = {}
    cl = torch.channels_last
    for n, h, w, c in ((4, 1280, 1280, 32), (4, 640, 640, 64)):
        x, wt, scale, shift, _ = conv_inputs(n, h, w, c, c, gen, False)
        w_cl = wt.permute(3, 2, 0, 1).contiguous(memory_format=cl)

        def library():
            y = F.conv2d(x.permute(0, 3, 1, 2), w_cl, padding=1)
            return torch.relu(y.float() * scale[:, None, None]
                              + shift[:, None, None]).to(torch.bfloat16)

        nbytes = 2 * (2 * n * h * w * c + 9 * c * c) + 8 * c
        flop = 2 * n * h * w * c * c * 9
        name = f"conv3x3_fused[C{c}@{n}x{h}^2]"
        out[name] = (cuda_ms(lambda: conv3x3_fused(x, wt, scale, shift, "relu"), 20, 3),
                     cuda_ms(lambda: conv3x3_fused_plain(x, wt, scale, shift, "relu"), 3),
                     cuda_ms(library, 20, 3), *roofline(nbytes, flop, BF16_FLOP_PER_S))
        del x, wt, w_cl
    x = randn((4, 1280, 1280, 32), gen)
    for mode, lib in (("max", F.max_pool2d), ("avg", F.avg_pool2d)):
        nbytes = 2 * 4 * 1280 * 1280 * 32 * 5 // 4
        out[f"pool2x[{mode}]"] = (
            cuda_ms(lambda: pool2x(x, mode), 50, 3),
            cuda_ms(lambda: pool2x_plain(x, mode), 5),
            cuda_ms(lambda: lib(x.permute(0, 3, 1, 2), 2), 50, 3),
            *roofline(nbytes, 4 * 640 * 640 * 32 * 4, F32_FLOP_PER_S))
    del x
    for n, h, w, cin, mode in ((4, 320, 320, 128, None),
                               (4, 640, 640, 64, "post_act_half")):
        cout = cin // 2
        x, wt, scale, shift, res = deconv_inputs(n, h, w, cin, cout, gen, mode)
        w_t = wt.permute(2, 3, 0, 1).contiguous(memory_format=cl)
        nbytes = 2 * (n * h * w * cin + 9 * cin * cout
                      + 4 * n * h * w * cout * (2 if mode else 1)) + 8 * cout
        flop = 2 * n * h * w * cin * cout * 9
        rm = mode or "post_affine"
        out[f"deconv2x_fused[{cin}->{cout}@{n}x{h}^2]"] = (
            cuda_ms(lambda: deconv2x_fused(x, wt, scale, shift, "relu", res, rm), 20, 3),
            cuda_ms(lambda: deconv2x_fused_plain(x, wt, scale, shift, "relu", res, rm), 3),
            cuda_ms(lambda: F.conv_transpose2d(x.permute(0, 3, 1, 2), w_t, stride=2,
                                               padding=1, output_padding=1), 20, 3),
            *roofline(nbytes, flop, BF16_FLOP_PER_S))
        del x, wt, res, w_t
    x, w3, b3 = head_tail_inputs(4, 640, 640, 64, K, gen)
    w3_oihw = w3.permute(3, 2, 0, 1).contiguous()
    b3_bf = b3.to(torch.bfloat16)

    def library():
        up = F.interpolate(x[..., :K].permute(0, 3, 1, 2).contiguous(),
                           scale_factor=2, mode="bilinear", align_corners=True)
        return F.conv2d(up, w3_oihw, b3_bf, padding=1)

    nbytes = 2 * (4 * 640 * 640 * 64 + 9 * K * K + 4 * K * 1280 * 1280) + 4 * K
    flop = 2 * 4 * 1280 * 1280 * K * K * 9
    out["head_tail[K51@4x640^2]"] = (
        cuda_ms(lambda: head_tail(x, w3, b3), 10, 2),
        cuda_ms(lambda: head_tail_plain(x, w3, b3), 3),
        cuda_ms(library, 10, 2), *roofline(nbytes, flop, BF16_FLOP_PER_S))
    del x
    for name, (ms, plain, lib, b, by) in out.items():
        say(f"{name} kernel_ms", ms)
        say(f"{name} plain_ms", plain)
        say(f"{name} library_ms", lib)
        say(f"{name} bound_ms ({by})", b)
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
        "conv3x3_fused": max(
            check_conv(4, 1280, 1280, 32, 32, "relu", None, gen),
            check_conv(4, 1280, 1280, 32, 32, "leaky", "post", gen),
            check_conv(4, 640, 640, 64, 64, "relu", "pre", gen),
            check_conv(4, 640, 640, 64, 64, None, None, gen),
            check_conv(4, 1280, 1280, 2, 32, "leaky", None, gen),
            check_conv(4, 640, 640, 64, K, "relu", None, gen),
            check_conv(4, 1280, 1280, 32, 2, None, None, gen),
            check_conv(4, 1280, 1280, 32, 1, "relu", "pre", gen),
            check_conv(2, 37, 53, K, K, "leaky", "post", gen)),
        "pool2x": max(
            check_pool(4, 1280, 1280, 32, "max", gen),
            check_pool(4, 1280, 1280, 32, "avg", gen),
            check_pool(2, 37, 53, K, "max", gen),
            check_pool(2, 37, 53, K, "avg", gen)),
        "deconv2x_fused": max(
            check_deconv(4, 320, 320, 128, 64, "relu", None, gen),
            check_deconv(4, 640, 640, 64, 32, "relu", "post_act_half", gen),
            check_deconv(4, 320, 320, 128, 64, "leaky", "post_affine", gen),
            check_deconv(2, 37, 53, K, 27, "relu", "post_act_half", gen)),
        "head_tail": max(
            check_head_tail(4, 640, 640, 64, K, gen),
            check_head_tail(2, 37, 53, K, K, gen)),
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
    for path, (_, ms) in runs.items():
        say(f"full bfloat16 {path} ms_per_section, this phase", ms)
    out["launches"] = {k: v[0] for k, v in runs.items()}

    phase("15 new kernels' times at full width (CUDA events)")
    out["times"] = time_new_kernels(gen)
    return out


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
        for name, (ms, plain, lib, b, by) in res["times"].items():
            if name.split("[")[0] != kernel:
                continue
            entries.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": res["launches"][path][kernel],
                "max_abs_err": res["err"][kernel], "ms": ms,
                "plain_ms": plain, "bound_ms": b, "bound_by": by,
                "library_ms": lib})
    return entries


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
    from sstem_tpu_torch.kernels import (
        _build,
        sepconv_planar,
        sepconv_planar_bwd,
        sepconv_planar_bwd_plain,
        sepconv_planar_plain,
        serving_warp,
    )
    from sstem_tpu_torch.ops.warp import spatial_transform

    config.disable_tf32()
    print("TF32 off: cudnn.allow_tf32 = cuda.matmul.allow_tf32 = False")

    phase("2 build")
    t0 = time.perf_counter()
    path, log = _build.build()
    _build.library()
    print(log.strip())
    say("build seconds", time.perf_counter() - t0)

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    phase("3 sepconv kernel vs plain")
    f32, bf16 = config.PARITY_DTYPE, config.SERVING_DTYPE
    sep_err = {
        "f32": check_sepconv(4, 1, 1280, 1280, K, f32, f32, gen),
        "f32_image_bf16_maps": check_sepconv(4, 1, 1280, 1280, K, f32, bf16, gen),
        "bf16": check_sepconv(4, 1, 1280, 1280, K, bf16, bf16, gen),
    }
    check_sepconv(2, 3, 251, 179, K, f32, f32, gen)
    check_sepconv(2, 3, 251, 179, K, bf16, bf16, gen)
    check_sepconv(2, 2, 64, 96, 5, f32, f32, gen)

    phase("4 warp kernel vs plain")
    im = rand((4, 1280, 1280, 1), gen)
    fold = fold_flows(4, 1280, 1280, SEED)
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
    for name, dt in (("f32", f32), ("bf16", bf16)):
        image = rand((4, 1, 1280 + K - 1, 1280 + K - 1), gen, dtype=dt)
        vert = rand((4, K, 1280, 1280), gen, 2.0 / K, dt)
        horz = rand((4, K, 1280, 1280), gen, 2.0 / K, dt)
        ms = cuda_ms(lambda: sepconv_planar(image, vert, horz), reps=10)
        plain = cuda_ms(lambda: sepconv_planar_plain(image, vert, horz), reps=3)
        say(f"sepconv 4x1x1280x1280 K=51 {name} kernel_ms", ms)
        say(f"sepconv 4x1x1280x1280 K=51 {name} plain_ms", plain)
        times[f"sepconv_{name}"] = (ms, plain)
        del image, vert, horz
    ms = cuda_ms(lambda: serving_warp(im, fold), reps=20)
    plain = cuda_ms(lambda: spatial_transform(im, fold), reps=5)
    say("warp 4x1280x1280 fold kernel_ms", ms)
    say("warp 4x1280x1280 fold plain_ms", plain)
    times["warp"] = (ms, plain)

    phase("8 sepconv backward kernel vs plain")
    # the training shape is checked in phase 11, on the inputs it times
    bwd_err = check_sepconv_bwd(2, 3, 61, 47, 11, f32, gen)
    # more channels than fit in shared memory at K=51: the chunked path
    bwd_err = max(bwd_err, check_sepconv_bwd(1, 13, 40, 40, K, f32, gen))
    check_sepconv_bwd(2, 1, 64, 96, 5, bf16, gen)

    phase("9 IFNet training step card vs cpu (K=51, 64^2, float32, TF32 off)")
    train_step_card_vs_cpu()

    phase("10 full width training: IFNet K=51, 256^2, batch 32, L1, AdamW")
    train_launches = full_width_training()

    phase("11 sepconv kernels vs plain and their times at the training shape")
    n, hw = TRAIN_BATCH, TRAIN_PATCH
    image = rand((n, 1, hw + K - 1, hw + K - 1), gen)
    vert = rand((n, K, hw, hw), gen, 2.0 / K)
    horz = rand((n, K, hw, hw), gen, 2.0 / K)
    grad = rand((n, 1, hw, hw), gen) - 0.5
    label = f"{n}x1x{hw}x{hw} K=51 f32"
    fwd_train_err = assert_sepconv_close(
        f"sepconv {label}", sepconv_planar(image, vert, horz),
        sepconv_planar_plain(image, vert, horz), (n, 1, hw, hw))
    bwd_err = max(bwd_err, assert_sepconv_bwd_close(
        f"sepconv_bwd {label}", sepconv_planar_bwd(image, vert, horz, grad),
        sepconv_planar_bwd_plain(image, vert, horz, grad), (n, K, hw, hw)))
    for name, fn, plain in (
            ("sepconv_fwd_train", lambda: sepconv_planar(image, vert, horz),
             lambda: sepconv_planar_plain(image, vert, horz)),
            ("sepconv_bwd", lambda: sepconv_planar_bwd(image, vert, horz, grad),
             lambda: sepconv_planar_bwd_plain(image, vert, horz, grad))):
        ms = cuda_ms(fn, reps=20, warmup=3)
        plain_ms = cuda_ms(plain, reps=2)
        say(f"{name} {label} kernel_ms", ms)
        say(f"{name} {label} plain_ms", plain_ms)
        times[name] = (ms, plain_ms)
    del image, vert, horz, grad

    packed = packed_phases(gen, stack, ids)

    kernels = []
    for name, dt in (("f32", f32), ("bf16", bf16)):
        nbytes = 4 if dt == f32 else 2
        bound, by = sepconv_bound(4, 1, 1280, 1280, K, nbytes, nbytes, False)
        kernels.append({
            "name": f"sepconv_fwd[{name}]", "route": "cuda",
            "source": "sstem_tpu_torch/csrc/sepconv_fwd.cu",
            "replaces": "sstem_tpu/kernels/sepconv.py:240",
            "launches": launches[name]["sepconv_fwd"],
            "max_abs_err": sep_err[name],
            "ms": times[f"sepconv_{name}"][0],
            "plain_ms": times[f"sepconv_{name}"][1],
            "bound_ms": bound, "bound_by": by, "library_ms": None})
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
    bound, by = sepconv_bound(n, 1, hw, hw, K, 4, 4, False)
    kernels.append({
        "name": "sepconv_fwd[train_f32]", "route": "cuda",
        "source": "sstem_tpu_torch/csrc/sepconv_fwd.cu",
        "replaces": "sstem_tpu/kernels/sepconv.py:240",
        "launches": train_launches["sepconv_fwd"],
        "max_abs_err": fwd_train_err,
        "ms": times["sepconv_fwd_train"][0],
        "plain_ms": times["sepconv_fwd_train"][1],
        "bound_ms": bound, "bound_by": by, "library_ms": None})
    bound, by = sepconv_bound(n, 1, hw, hw, K, 4, 4, True)
    kernels.append({
        "name": "sepconv_bwd", "route": "cuda",
        "source": "sstem_tpu_torch/csrc/sepconv_bwd.cu",
        "replaces": "sstem_tpu/kernels/sepconv.py:287",
        "launches": train_launches["sepconv_bwd"],
        "max_abs_err": bwd_err,
        "ms": times["sepconv_bwd"][0], "plain_ms": times["sepconv_bwd"][1],
        "bound_ms": bound, "bound_by": by, "library_ms": None})
    kernels += new_kernel_entries(packed)
    for kern in kernels:
        say(f"{kern['name']} bound_ms ({kern['bound_by']})", kern["bound_ms"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
