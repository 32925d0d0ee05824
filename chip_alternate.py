#!/usr/bin/env python3
"""Two checkouts of the port alternating on one CUDA card.

    python3 chip_alternate.py PARENT_DIR

Runs chip_smoke.py's end-to-end workloads from the parent checkout
PARENT_DIR ('p') and from this one ('c') in turn, each run in a process of
its own started from that checkout's root (so each imports and builds its
own kernels): the probes' tile copy at phase 19b's shapes (ms per call by
CUDA events, the median of 5 rounds of 50 calls that alternate with
``y.copy_(x)``), gather and roll (alternating likewise with
``torch.gather`` / ``torch.roll`` with the shift read to the host, and the
host microseconds per call), the interp training step
(``full_width_training``: IFNet K=51, batch 32 x 256^2, f32 TF32 off), the
SFF restore in bf16 on the cuDNN path and on the packed path with fused
head tails (``full_size_run``, 25 x 1250^2, 12 sections), and the SP
restore (``sp_full_width``, 6 quartets of 1250^2, batch 2) on every path
the tree's chip_smoke.py has (``SP_PATHS``: the served paths; a tree
without it runs the cuDNN and packed paths), in the order parent, change,
change, parent. Each run's full output goes to ``build/alternate/``; the
summary prints each metric's value in every run, in order (None where a
tree lacks the path), and the mean of the change's runs minus the mean of
the parent's where both trees ran it. Make the parent checkout with
``git archive <commit> | tar -x -C PARENT_DIR``, in a directory that
.gitignore lists.
"""

import os
import re
import statistics
import subprocess
import sys

# run from a checkout's root; uses only what chip_smoke.py and the probes
# have had since the training step, the SP restore and the probes were
# ported
WORKLOADS = r"""
import subprocess
import numpy as np
import torch
import chip_smoke as cs
from sstem_tpu_torch import config
from sstem_tpu_torch.data import synth_stack

cs.GPU = subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
config.disable_tf32()

import statistics
import time
from sstem_tpu_torch.kernels import roll_dynamic, take_along_axis
from sstem_tpu_torch.tools import probe_gather as pg

def paired(kernel, library, rounds=5, reps=50):
    ms = {kernel: [], library: []}
    for _ in range(rounds):
        for fn in ms:
            ms[fn].append(cs.cuda_ms(fn, reps, 5))
    return [statistics.median(v) for v in ms.values()]

def host_us(fn, reps=200):
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return us

gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
from sstem_tpu_torch.kernels import tile_copy
from sstem_tpu_torch.tools import probe_dma_conv as pdc
for label, shape in pdc.COPY_SHAPES:
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    y = torch.empty_like(x)
    ms = paired(lambda: tile_copy(x, pdc.COPY_TY), lambda: y.copy_(x))
    name = f"probe copy {'x'.join(map(str, shape))} bf16"
    cs.say(f"{name} ms_per_call", ms[0])
    cs.say(f"{name} copy_ ms_per_call", ms[1])
    del x, y
for axis, rows, cols in pg.GATHER_CASES:
    src, idx = pg.gather_inputs(axis, rows, cols, "cuda", gen)
    idx64 = idx.long()
    kernel = lambda: take_along_axis(src, idx, axis)
    ms = paired(kernel, lambda: torch.gather(src, axis, idx64))
    name = f"probe gather axis={axis} {rows}x{cols}"
    cs.say(f"{name} ms_per_call", ms[0])
    cs.say(f"{name} torch.gather ms_per_call", ms[1])
    cs.say(f"{name} host_us_per_call", host_us(kernel))
for rows, cols in pg.ROLL_CASES:
    src = torch.rand((rows, cols), generator=gen, device="cuda")
    shift = torch.tensor([pg.ROLL_SHIFT], dtype=torch.int32, device="cuda")
    kernel = lambda: roll_dynamic(src, shift)
    ms = paired(kernel, lambda: torch.roll(src, int(shift.item()), 1))
    name = f"probe roll {rows}x{cols}"
    cs.say(f"{name} ms_per_call", ms[0])
    cs.say(f"{name} torch.roll ms_per_call", ms[1])
    cs.say(f"{name} host_us_per_call", host_us(kernel))

cs.full_width_training()
stack = synth_stack(25, 1250, 1250, seed=cs.SEED)
ids = list(range(1, 24, 2))
cs.full_size_run(stack, ids, config.SERVING_DTYPE)
cs.full_size_run(stack, ids, config.SERVING_DTYPE, "packed_fused_tail",
                 packed_conv=True, fused_head_tail=True)
del stack
sp = torch.from_numpy(synth_stack(4 * cs.SP_QUARTETS, cs.SP_SIZE, cs.SP_SIZE,
                                  seed=cs.SEED)).to("cuda")
rng = np.random.default_rng(3)
masks = torch.from_numpy(
    (rng.random(tuple(sp.shape)) > 0.8).astype(np.uint8) * 255).to("cuda")
for path in getattr(cs, "SP_PATHS", ("cudnn", "packed")):
    cs.sp_full_width(path, sp, masks)
"""

ORDER = "pccp"  # p: the parent checkout, c: this one
LOG_DIR = os.path.join("build", "alternate")
RUN_SECONDS = 900

METRICS = re.compile(
    r"^(train step ms \(median[^=]*"
    r"|train profile sepconv kernels device ms per step \(share of work\)"
    r"|train profile idle share"
    r"|full bfloat16 \S+ ms_per_section \(median of 5\)"
    r"|sp full \S+ \S+ ms_per_quartet \(median of 5\)"
    r"|probe (?:copy|gather|roll) .*?(?:ms|host_us)_per_call) = (\S+)")


def run(root, label):
    """One run of WORKLOADS from ``root``: {metric: value}."""
    proc = subprocess.run([sys.executable, "-c", WORKLOADS], cwd=root,
                          capture_output=True, text=True, timeout=RUN_SECONDS)
    with open(os.path.join(LOG_DIR, f"{label}.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{label} ({root}) exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    found = {}
    for line in proc.stdout.splitlines():
        m = METRICS.match(line)
        if m:
            found[m.group(1)] = float(m.group(2))
    return found


def main(argv):
    if len(argv) != 1:
        raise SystemExit(__doc__)
    here = os.path.dirname(os.path.abspath(__file__))
    roots = {"p": os.path.abspath(argv[0]), "c": here}
    for root in roots.values():
        if not os.path.exists(os.path.join(root, "chip_smoke.py")):
            raise SystemExit(f"{root}: no chip_smoke.py")
    os.makedirs(LOG_DIR, exist_ok=True)
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(gpu, flush=True)
    results = []
    for i, tree in enumerate(ORDER):
        label = f"{i}_{'parent' if tree == 'p' else 'change'}"
        results.append((tree, run(roots[tree], label)))
        print(f"run {label} done", flush=True)
    order = " ".join("parent" if t == "p" else "change" for t, _ in results)
    print(f"order: {order}  [{gpu}]")
    for key in dict.fromkeys(k for _, r in results for k in r):
        values = [r.get(key) for _, r in results]
        got = {t: [r[key] for tt, r in results if tt == t and key in r]
               for t in "pc"}
        diff = (f"change - parent {statistics.mean(got['c']) - statistics.mean(got['p'])}"
                if got["c"] and got["p"] else "one tree only")
        print(f"{key} = {values}; {diff}  [{gpu}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
