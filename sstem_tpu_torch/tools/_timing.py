"""What the tools share: timing (CUDA events on the card, the host clock on
the CPU), seeded generators, the numerical policy a profile runs under, and
the one error line a tool prints when it was asked for the card and there
is none."""

import contextlib
import json
import time

import torch

from sstem_tpu_torch import config


def seconds(fn, device, iters=8, warm=3):
    """Mean seconds per call of ``fn`` after ``warm`` untimed calls."""
    for _ in range(warm):
        fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def generator(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


@contextlib.contextmanager
def policy(precision, compute_dtype=None):
    """Run the block under ``config.set_matmul_precision(precision)`` and
    ``config.set_compute_dtype(compute_dtype)``; the caller's settings are
    set back after."""
    prior = config.matmul_precision(), config.compute_dtype()
    config.set_matmul_precision(precision)
    config.set_compute_dtype(compute_dtype)
    try:
        yield
    finally:
        config.set_matmul_precision(prior[0])
        config.set_compute_dtype(
            None if prior[1] is None else str(prior[1]).split(".")[-1])


def card_missing(tool, device="cuda"):
    """True, after printing the tool's one error line, where ``device`` is
    the card and torch finds none (the tool then exits 2, as
    ``tools/tpu_checks.py`` does without its TPU); False otherwise. No tool
    falls back to the CPU."""
    if torch.device(device).type != "cuda" or torch.cuda.is_available():
        return False
    print(json.dumps({tool: "error", "error": "gpu_unavailable",
                      "detail": "torch.cuda.is_available() is False"}))
    return True
