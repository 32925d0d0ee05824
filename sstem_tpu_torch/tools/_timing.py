"""Timing for the probes: CUDA events on the card, the host clock on the
CPU."""

import time

import torch


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
