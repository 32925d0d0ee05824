"""conv3x3 and deconv2x against variants of their CUDA sources, timed in
one process on the card.

    python -m sstem_tpu_torch.tools.conv_variants [--rounds 7] [--reps 20]

A variant is a copy of ``csrc/`` with literal text replaced in named files
(each replacement must match once), built with ``_build``'s flags, one
``nvcc`` per source, all started together, into a library of its own under
``build/conv_variants/<variant>/``. At each row every variant's C entry
point (``sstem_conv3x3_fused`` or ``sstem_deconv2x_fused``, which pick the
design by shape) runs on the same seeded inputs in alternating rounds of
CUDA events; the median of the rounds is kept. Each output is held to the
plain version: its largest error over 1 bf16 ulp of the value + 2^-14 of
the tensor's max (at most 1 is exact up to summation order). The variants:

* ``tree``: the sources as they are;
* ``mainloop_index_by_division``: the shared wgmma mainloop
  (``hopper.cuh: mainloop``, under conv3x3's wgmma and narrow_out designs
  and deconv's wgmma one) with its warpgroup index taken as
  ``threadIdx.x / 128`` instead of broadcast from lane 0 by ``__shfl_sync``:
  the code before that broadcast, on which ptxas serializes the wgmmas
  (warning C7520);
* ``narrow_out_without_wgmma``: conv3x3's narrow_out design with its
  wgmmas skipped (its output is then wrong): what the producer, the ring
  and the epilogue cost alone.

Prints each build's C7520 and spill lines, a line a row, and last one JSON
object {row: {variant: {"ms", "err_over_bound"}}}. Without a card it prints
one error line and exits 2.
"""

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from sstem_tpu_torch.kernels import _build, conv3x3, deconv
from sstem_tpu_torch.tools._timing import card_missing, generator

SOURCES = ("conv3x3_fused.cu", "conv3x3_narrow_in.cu", "deconv2x_fused.cu")
# variant -> {file: [(text, replacement), ...]}
VARIANTS = {
    "tree": {},
    "mainloop_index_by_division": {"hopper.cuh": [(
        "const int c = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x)"
        " / 128, 0);",
        "const int c = threadIdx.x / 128;")]},
    "narrow_out_without_wgmma": {"conv3x3_fused.cu": [(
        "          wgmma_m64k16(acc[j], ad, bd);",
        "          if (cin < 0) wgmma_m64k16(acc[j], ad, bd);")]},
}
# (kernel, n, h, w, cin, cout): the wgmma rows PERF.md's rows 4 and 5 cite,
# and narrow_out at the heads of the SFF and SP packed paths
ROWS = (("conv3x3", 4, 1280, 1280, 32, 32), ("deconv2x", 4, 320, 320, 128, 64),
        ("deconv2x", 4, 640, 640, 64, 32), ("conv3x3", 4, 1280, 1280, 32, 1),
        ("conv3x3", 2, 1280, 1280, 64, 1))
ENTRIES = {"conv3x3": "sstem_conv3x3_fused", "deconv2x": "sstem_deconv2x_fused"}


def build(name, patches, root):
    """Library path of one variant; ptxas's C7520 and spill lines printed."""
    folder = os.path.join(root, name)
    shutil.rmtree(folder, ignore_errors=True)
    shutil.copytree(_build.SOURCES[0].parent, folder)
    for file, reps in patches.items():
        path = os.path.join(folder, file)
        with open(path) as f:
            text = f.read()
        for old, new in reps:
            assert text.count(old) == 1, (name, file, old)
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
    nvcc = _build._nvcc()
    if nvcc is None:
        raise RuntimeError("conv_variants builds with nvcc, and none was found")

    def compile_one(src):
        obj = os.path.join(folder, src + ".o")
        proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-c", "-o", obj,
                               os.path.join(folder, src)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{name} {src}:\n{proc.stderr[-3000:]}")
        return obj, proc.stdout + proc.stderr

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(compile_one, SOURCES))
    for src, (_, log) in zip(SOURCES, built):
        for line in log.splitlines():
            if "C7520" in line or ("spill" in line and
                                   " 0 bytes spill stores, 0 bytes spill loads"
                                   not in line):
                print(f"{name} {src}: {line.strip()[:240]}", flush=True)
    lib = os.path.join(folder, "libvariant.so")
    subprocess.run([nvcc, "-shared", "-o", lib, *[o for o, _ in built]],
                   check=True)
    return lib


def err_over_bound(got, want):
    """The largest |got - want| over 1 bf16 ulp of the value + 2^-14 of the
    max |want|."""
    g, w = got.float(), want.float()
    m = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(m)) - 7)
    floor = 2.0 ** -14 * float(w.abs().max())
    return float(((g - w).abs() / (ulp + floor)).max())


def run_row(fns, kernel, n, h, w, cin, cout, gen, rounds, reps):
    """{variant: {"ms", "err_over_bound"}} at one row."""
    x = torch.randn((n, h, w, cin), generator=gen, device="cuda").bfloat16()
    fan = 9 * cin if kernel == "conv3x3" else 2.25 * cin
    wt = (torch.randn((3, 3, cin, cout), generator=gen, device="cuda")
          * (2.0 / fan) ** 0.5).bfloat16()
    scale = torch.rand(cout, generator=gen, device="cuda") + 0.5
    shift = torch.randn(cout, generator=gen, device="cuda") * 0.1
    if kernel == "conv3x3":
        want = conv3x3.conv3x3_fused_plain(x, wt, scale, shift, "relu")
    else:
        want = deconv.deconv2x_fused_plain(x, wt, scale, shift, "relu")
    outs, calls = {}, {}
    for name, lib in fns.items():
        fn = getattr(lib, ENTRIES[kernel])
        out = torch.empty_like(want)
        stream = torch.cuda.current_stream().cuda_stream
        args = (x.data_ptr(), wt.data_ptr(), scale.data_ptr(),
                shift.data_ptr(), None, out.data_ptr(), n, h, w, cin, cout, 1,
                0, stream)

        def call(fn=fn, args=args, name=name):
            rc = fn(*args)
            if rc:
                raise RuntimeError(f"{name} {ENTRIES[kernel]}: error {rc}")

        call()
        outs[name], calls[name] = out, call
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(rounds):
        for name, call in calls.items():
            for _ in range(5):
                call()
            start.record()
            for _ in range(reps):
                call()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / reps)
    return {name: {"ms": statistics.median(times[name]),
                   "err_over_bound": err_over_bound(outs[name], want)}
            for name in fns}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=7)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if card_missing("conv_variants"):
        return 2
    root = str(_build.BUILD_DIR.parent / "conv_variants")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(
            lambda kv: build(*kv, root), VARIANTS.items())))
    fns = {name: ctypes.CDLL(path) for name, path in libs.items()}
    for lib in fns.values():
        for entry in ENTRIES.values():
            getattr(lib, entry).argtypes = ([ctypes.c_void_p] * 6
                                            + [ctypes.c_int] * 7
                                            + [ctypes.c_void_p])
            getattr(lib, entry).restype = ctypes.c_int
    gen = generator("cuda", args.seed)
    result = {}
    for kernel, n, h, w, cin, cout in ROWS:
        row = f"{kernel}[{cin}->{cout}@{n}x{h}x{w}]"
        result[row] = run_row(fns, kernel, n, h, w, cin, cout, gen,
                              args.rounds, args.reps)
        print(row, "  ".join(f"{k}={v['ms']:.4f} ms (err/bound "
                             f"{v['err_over_bound']:.3g})"
                             for k, v in result[row].items()), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
