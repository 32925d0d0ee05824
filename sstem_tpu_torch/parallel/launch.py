"""Start a process group from Python: ``spawn`` runs one function on every
rank, each in a process of its own, and returns the ranks' results.

The dry run (``sstem_tpu_torch.dryrun``), ``chip_smoke.py`` and the CPU
tests start their groups here; a trainer launched by torchrun joins its
group in ``cli.common.rank_device`` instead.
"""

import multiprocessing as mp
import queue
import socket
import time
import traceback

from sstem_tpu_torch import config
from sstem_tpu_torch.parallel import ddp


def free_port():
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, inbox, device, backend, init_method,
               results, precision):
    """One rank: set the parent's matmul ``precision`` (``config.py``), take
    ``fn``'s arguments from ``inbox``, join the group, run ``fn`` and report
    (rank, True, result), then leave the group; or report (rank, False,
    traceback) and exit, the parent then killing every rank (a rank that
    failed may leave its peers waiting in a collective)."""
    try:
        config.set_matmul_precision(precision)
        args = inbox.get()
        device = ddp.init_process_group(backend, init_method, rank, world,
                                        device=device)
        out = (rank, True, fn(rank, world, device, *args))
    except BaseException:  # reported to the parent, which re-raises
        results.put((rank, False, traceback.format_exc()))
        return
    results.put(out)
    ddp.teardown()


def spawn(fn, world, *args, device="cuda", backend=None, init_method=None,
          timeout_s=600.0):
    """Run ``fn(rank, world, rank_device, *args)`` on ``world`` ranks and
    return their results in rank order.

    Each rank is a process of the 'spawn' context (a fresh interpreter:
    ``fn``, ``args`` and the results must pickle, and ``fn`` must be
    importable by its module's name) that joins the group with
    ``ddp.init_process_group(backend, init_method, rank, world,
    device=device)``, which gives ``rank_device``, before ``fn`` and
    leaves it after. ``device`` defaults to the card, as every entry point
    of the port does; the CPU runs ranks only when asked (``device="cpu"``,
    under gloo). ``init_method``
    defaults to a free TCP port on localhost. If a rank raises or dies,
    every rank is killed and the parent raises a RuntimeError carrying
    that rank's traceback; if the ranks are not all done within
    ``timeout_s`` seconds, every rank is killed and the parent raises
    TimeoutError."""
    ctx = mp.get_context("spawn")
    init_method = init_method or f"tcp://localhost:{free_port()}"
    # the arguments go through a queue, not the process objects: a start
    # whose pickle outgrows the pipe waits until the child has imported
    # torch, and the ranks would start one after another
    inbox, results = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, inbox, device, backend,
                               init_method, results,
                               config.matmul_precision()))
             for r in range(world)]
    for p in procs:
        p.start()
    for _ in procs:
        inbox.put(args)
    done = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(done) < world:
            try:
                rank, ok, out = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} of {world} died with exit code "
                        f"{procs[dead[0]].exitcode} and no result")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world} ranks of {getattr(fn, '__name__', fn)} "
                        f"not done within {timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
            done[rank] = out
    finally:
        for p in procs:
            if p.is_alive() and len(done) < world:
                p.kill()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        for q in (inbox, results):
            q.close()
            q.cancel_join_thread()
    return [done[r] for r in range(world)]
