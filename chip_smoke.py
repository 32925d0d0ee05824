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

Every number is printed on its own line beside the card's name and power
limit. The line before the last is the kernels' JSON summary; the last line
is {"ok": true, "device": {...}}. Weights are random, made from seeds; this
script imports nothing of JAX.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
K = 51
GPU = None  # "name, power limit" from nvidia-smi


def say(key, value):
    print(f"{key} = {value}  [{GPU}]", flush=True)


def phase(name):
    print(f"--- {name}", flush=True)


def bf16_ulp(x):
    """One bf16 unit in the last place of |x| (8 significant bits)."""
    m = x.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


def rand(shape, gen, scale=1.0, dtype=torch.float32):
    return (torch.rand(shape, generator=gen, device="cuda") * scale).to(dtype)


def check_sepconv(n, c, h, w, k, image_dtype, maps_dtype, gen):
    """Kernel vs plain on the same unit-range image and maps whose taps sum
    to about 1 per pixel. Returns the max abs error."""
    from sstem_tpu_torch.kernels import sepconv_planar, sepconv_planar_plain

    image = rand((n, c, h + k - 1, w + k - 1), gen, dtype=image_dtype)
    vert = rand((n, k, h, w), gen, 2.0 / k, maps_dtype)
    horz = rand((n, k, h, w), gen, 2.0 / k, maps_dtype)
    got = sepconv_planar(image, vert, horz)
    want = sepconv_planar_plain(image, vert, horz)
    torch.cuda.synchronize()
    assert got.dtype == image_dtype and got.shape == (n, c, h, w)
    err = (got.float() - want.float()).abs()
    label = f"sepconv {n}x{c}x{h}x{w} K={k} image={image_dtype} maps={maps_dtype}"
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


def build_pipeline(device, dtype, seed=SEED, kernel_size=K):
    """SFFPipeline on seeded random weights. The kernel heads' last conv is
    rescaled so each frame's taps sum to about 1/sqrt(2), as a trained KPN's
    do; otherwise the interp saturates at the clip and hides the sepconv."""
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
                       UNetSFF(generator=g), device=device, dtype=dtype)


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


def full_size_run(stack, ids, dtype, chunk=4):
    """The bench workload in one dtype. Returns the kernels' launch counts
    during one restore_stack_scanned call."""
    from sstem_tpu_torch.kernels import sepconv_planar, serving_warp

    name = str(dtype).removeprefix("torch.")
    pipe = build_pipeline("cuda", dtype)
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
    sepconv_planar.launches = 0
    serving_warp.launches = 0
    out = pipe.restore_stack_scanned(stack, ids, chunk=chunk)
    torch.cuda.synchronize()
    launches = {"sepconv_fwd": sepconv_planar.launches,
                "warp_bilinear": serving_warp.launches}
    del pipe.section
    say(f"full {name} groups", groups)
    say(f"full {name} sepconv launches", launches["sepconv_fwd"])
    say(f"full {name} warp launches", launches["warp_bilinear"])
    assert launches == {"sepconv_fwd": 2 * groups, "warp_bilinear": groups}
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

    phase("3 sepconv kernel vs plain")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
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
    launches = {"bf16": full_size_run(stack, ids, bf16),
                "f32": full_size_run(stack, ids, f32)}

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

    kernels = []
    for name in ("f32", "bf16"):
        kernels.append({
            "name": f"sepconv_fwd[{name}]", "route": "cuda",
            "source": "sstem_tpu_torch/csrc/sepconv_fwd.cu",
            "replaces": "sstem_tpu/kernels/sepconv.py:240",
            "launches": launches[name]["sepconv_fwd"],
            "max_abs_err": sep_err[name],
            "ms": times[f"sepconv_{name}"][0],
            "plain_ms": times[f"sepconv_{name}"][1]})
    kernels.append({
        "name": "warp_bilinear", "route": "cuda",
        "source": "sstem_tpu_torch/csrc/warp_bilinear.cu",
        "replaces": "sstem_tpu/kernels/warp_band.py:64",
        "launches": sum(v["warp_bilinear"] for v in launches.values()),
        "max_abs_err": warp_err, "ms": times["warp"][0],
        "plain_ms": times["warp"][1]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
