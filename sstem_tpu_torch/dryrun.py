"""Entry points of the port for a one-card compile check and a multi-rank
dry run (counterpart of ``__graft_entry__.py``: ``entry`` and
``dryrun_multichip``).

``entry()`` gives the flagship forward, the SFF interpolation KPN (IFNet,
K=51) whose hot op is the sepconv kernel. ``dryrun_multichip(n)`` runs one
data-parallel training step on ``n`` ranks (``parallel.launch.spawn``;
ranks share the cards where there are fewer, under gloo) on random data,
checks its loss against the one-process step on the same global batch and
the same initial weights, then runs the dp x sp sharded SFF restore on an
``n``-device mesh.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from sstem_tpu_torch.compat.config import AttrDict
from sstem_tpu_torch.config import apply_matmul_precision


def entry(device="cuda"):
    """(fn, args): ``fn(*args)`` is the IFNet K=51 forward on one 1 x 6 x
    256^2 input on ``device``, weights from seed 0, in eval mode without
    autograd."""
    from sstem_tpu_torch.models import IFNet

    apply_matmul_precision()
    model = IFNet(kernel_size=51, generator=torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    x = torch.zeros(1, 6, 256, 256, device=device)

    @torch.inference_mode()
    def fn(model, inputs):
        return model(inputs)

    return fn, (model, x)


def dryrun_config(batch_size):
    """The dry run's trainer config: IFNet K=5, L1, AdamW under the poly
    LR (``__graft_entry__.py``'s)."""
    return AttrDict({
        "NAME": "dryrun",
        "TRAIN": {
            "kernel_size": 5, "base_lr": 1e-3, "end_lr": 1e-4,
            "warmup_iters": 0, "decay_iters": 100, "power": 1.5,
            "weight_decay": 1e-4, "loss": "L1", "batch_size": batch_size,
        },
    })


def dryrun_inputs(n):
    """A random global batch of ``n``: (n, 6, 32, 32) inputs and (n, 1, 32,
    32) targets in [0, 1), from seed 42. Random, not zeros: a broken
    gradient or loss all-reduce would still give a loss of 0 on zeros."""
    g = torch.Generator().manual_seed(42)
    return (torch.rand(n, 6, 32, 32, generator=g),
            torch.rand(n, 1, 32, 32, generator=g))


def train_step_loss(device, batch, rank=0, world=1):
    """The loss of one ``train_interp.build`` step (weights from seed 0) on
    rank ``rank``'s rows of the global ``batch``, under the process group
    when there is one (DDP), else in one process on the whole batch; in
    float32 at the precision policy, as the trainers run (a rank, a fresh
    process, takes the caller's policy from ``launch.spawn``)."""
    from sstem_tpu_torch.cli import train_interp
    from sstem_tpu_torch.parallel import rank_rows
    from sstem_tpu_torch.train.trainer import TrainState

    apply_matmul_precision()
    n = batch[0].shape[0]
    model, opt, step, _, _, _ = train_interp.build(dryrun_config(n), device,
                                                   seed=0)
    rows = rank_rows(tuple(t.to(device) for t in batch), rank, world)
    _, metrics = step(TrainState(model, opt), rows)
    return float(metrics["loss"])


def _rank_step(rank, world, device, batch):
    return train_step_loss(device, batch, rank, world)


def _mesh_devices(n, device):
    """``n`` devices for a mesh: the card's devices in turn (repeated where
    there are fewer than ``n``), or ``device`` ``n`` times."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def dryrun_multichip(n_devices, device="cuda", backend=None, timeout_s=600):
    """One data-parallel train step on ``n_devices`` ranks, then the dp x sp
    sharded restore; raises on a mismatch.

    The step: ``train_interp.build`` (IFNet K=5, L1) on a random global
    batch of ``n_devices`` at 32^2, one row a rank; every rank's loss is
    above 0 and equals the one-process step's on the same batch and
    initial weights within 1e-5 relative. ``backend`` defaults to the
    device's (``ddp.default_backend``), but to gloo where ranks must share
    a card, which NCCL cannot run. The restore (in this process, while the
    ranks run):
    ``SFFPipeline.restore_stack_sharded`` with K=51, FusionNet and UNetSFF
    from seeds, on a (n/2) x 2 mesh (a 1-row mesh for odd n) of 256^2
    sections, halo 64. Prints one line; returns the loss."""
    from sstem_tpu_torch.infer.pipeline import SFFPipeline
    from sstem_tpu_torch.models import FusionNet, IFNet, UNetSFF
    from sstem_tpu_torch.parallel import ddp, launch, make_mesh

    apply_matmul_precision()
    if backend is None:
        backend = ddp.default_backend(device)
        if backend == "nccl" and n_devices > torch.cuda.device_count():
            backend = "gloo"
    n_sp = 2 if n_devices % 2 == 0 else 1
    n_dp = n_devices // n_sp
    batch = dryrun_inputs(n_devices)
    # the ranks start (a fresh interpreter each) while this process restores
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch.spawn, _rank_step, n_devices, batch,
                            device=device, backend=backend,
                            timeout_s=timeout_s)
        if n_sp > 1:
            g = torch.Generator().manual_seed(0)
            pipe = SFFPipeline(IFNet(51, generator=g),
                               FusionNet(output_nc=2, generator=g),
                               UNetSFF(generator=g), device=device)
            mesh = make_mesh(n_data=n_dp, n_space=n_sp,
                             devices=_mesh_devices(n_devices, device))
            rng = np.random.default_rng(0)
            hw = 256
            stack = (rng.random((n_dp + 2, hw, hw)) * 255).astype(np.uint8)
            res = pipe.restore_stack_sharded(stack, list(range(1, 1 + n_dp)),
                                             mesh, halo=64)
            assert all(v["fused"].shape == (hw, hw) for v in res.values())
        ref = train_step_loss(device, batch)
        losses = ranks.result()
    loss = losses[0]
    assert loss > 0.0, "dry-run loss should be nonzero on random data"
    for r, got in enumerate(losses):
        assert abs(got - ref) <= 1e-5 * max(1.0, abs(ref)), (
            f"rank {r} of {n_devices}: loss {got} != one-process loss {ref}: "
            "the gradient or loss all-reduce is broken")
    print(
        f"dryrun_multichip: ok on {n_devices} ranks "
        f"(dp={n_devices}, dpxsp={n_dp}x{n_sp}), "
        f"loss={loss:.6f} == one-process loss {ref:.6f} "
        f"(parity asserted at 1e-5)", flush=True)
    return loss
