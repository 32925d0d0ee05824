"""Data-parallel training across processes (counterpart of the JAX
package's data-parallel train step: ``make_train_step(..., mesh=)`` in
``sstem_tpu/train/trainer.py`` and ``build(cfg, data_parallel=True)`` of the
three SFF trainers).

The JAX step replicates the state and shards the global batch over the
mesh's 'data' axis: it is the one-device step on the global batch, its
BatchNorm statistics span the whole batch, and its loss and gradient are
the batch's means. The port runs one process per rank under
``torch.distributed`` and gets the same step from three pieces:

  * ``wrap`` (``DistributedDataParallel``) broadcasts rank 0's weights, as
    ``replicate`` does, and averages the gradient, which is the global
    batch's mean gradient when every rank holds an equal shard
    (``rank_rows``);
  * ``CrossRankBatchNorm2d`` all-reduces its statistics, so that each rank
    normalises its rows with the global batch's mean and variance;
  * ``all_mean`` reports a metric's global mean.

Launch a trainer with ``torchrun --nproc-per-node N -m
sstem_tpu_torch.cli.train_unfolding -c CFG``, or start ranks from Python
with ``parallel.launch.spawn``.
"""

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.nn import functional as dist_nn
from torch.nn.parallel import DistributedDataParallel

from sstem_tpu_torch.models.layers import BatchNorm2d


def default_backend(device):
    """'nccl' for a CUDA device, 'gloo' for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def is_distributed():
    return dist.is_available() and dist.is_initialized()


def rank():
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if is_distributed() else 0


def world_size():
    """The number of ranks, 1 without a process group."""
    return dist.get_world_size() if is_distributed() else 1


def device_for_rank(local_rank, device="cuda", backend=None,
                    local_world_size=1):
    """The device that the rank with index ``local_rank`` on its host runs
    on: ``cuda:{local_rank % device_count}`` for a CUDA ``device``, else
    ``device`` itself.

    As in ``make_mesh``, ranks may repeat a card: a host with one card
    puts every rank on ``cuda:0``. NCCL cannot run two ranks on one card,
    so with ``backend='nccl'`` and more ranks on the host
    (``local_world_size``) than cards this raises a ValueError naming two
    ranks that would share one; nothing moves to the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("device_for_rank: no CUDA device is visible")
    index = local_rank % count
    if backend == "nccl" and local_world_size > count:
        peers = [r for r in range(local_world_size) if r % count == index]
        if len(peers) > 1:
            raise ValueError(
                f"nccl cannot run two ranks on one card: ranks {peers[0]} "
                f"and {peers[1]} would share cuda:{index} ({local_world_size} "
                f"ranks, {count} card(s)); use the gloo backend")
    return torch.device("cuda", index)


def init_process_group(backend=None, init_method=None, rank=None,
                       world_size=None, device="cuda"):
    """Join the process group and return this rank's device
    (``device_for_rank``).

    With no arguments it reads torchrun's environment: RANK, LOCAL_RANK,
    WORLD_SIZE and LOCAL_WORLD_SIZE, and MASTER_ADDR and MASTER_PORT
    through the 'env://' rendezvous. ``backend`` defaults to
    ``default_backend(device)``. Given ``rank`` and ``world_size`` (one
    host, as ``launch.spawn`` starts it), the local rank is the rank."""
    env = os.environ
    rank = int(env["RANK"]) if rank is None else rank
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    backend = backend or default_backend(device)
    device = device_for_rank(local_rank, device, backend, local_world)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    return device


def teardown():
    """Leave the process group, if there is one."""
    if is_distributed():
        dist.destroy_process_group()


def barrier():
    """Wait for every rank; nothing without a process group."""
    if is_distributed():
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (``obj`` itself without a group)."""
    if not is_distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def shared_seed(seed):
    """``seed``, or for an unseeded run (None or -1) under a process group
    one fresh seed drawn on rank 0 and broadcast, so that every rank draws
    the same global batches and the same model."""
    if seed not in (None, -1) or not is_distributed():
        return seed
    return broadcast_object(
        int(np.random.SeedSequence().entropy) if rank() == 0 else None)


def local_batch_size(batch_size, world):
    """The rows a rank takes of a global batch; raises a ValueError when
    the batch does not divide among the ranks (as the reference trainers
    do, main_ms.py:97-103)."""
    if batch_size % world:
        raise ValueError(f"a batch of {batch_size} does not divide among "
                         f"{world} ranks")
    return batch_size // world


def rank_rows(batch, rank, world):
    """This rank's contiguous rows of a global batch, as ``P('data')``
    splits it: rows ``[rank * n, (rank + 1) * n)`` with ``n = B / world``.
    ``batch`` is a tensor or array, or a tuple, list or dict of them."""
    if isinstance(batch, dict):
        return {k: rank_rows(v, rank, world) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(rank_rows(v, rank, world) for v in batch)
    n = local_batch_size(batch.shape[0], world)
    return batch[rank * n:(rank + 1) * n]


def all_mean(t):
    """A metric's mean over the ranks (``t`` itself without a group)."""
    if not is_distributed():
        return t
    total = t.detach().reshape(1).clone()
    dist.all_reduce(total)
    return (total / dist.get_world_size())[0]


class CrossRankBatchNorm2d(BatchNorm2d):
    """BatchNorm whose train-mode statistics span every rank's rows.

    It keeps ``models.layers.BatchNorm2d``'s parameters, buffers and
    state-dict keys, so the weight importers and reference checkpoints
    load unchanged. In train mode under a process group it all-reduces the
    per-channel sum and count, then the sum of squared deviations from the
    global mean (two passes, as one-process BatchNorm computes the
    variance), normalises with the global mean and the biased global
    variance, and moves ``running_var`` toward the unbiased one, n / (n - 1)
    over the global count. The all-reduces are differentiable
    (``torch.distributed.nn``), and their backward sums the ranks'
    gradients: with DDP's averaging the parameters' gradient is the global
    batch's, and an input's gradient is world-size times the global mean
    loss's. In eval mode, or with no process group, it is the one-process
    BatchNorm and makes no collective call. (``nn.SyncBatchNorm`` takes
    CUDA tensors only and gathers with ``all_gather``, which gloo does not
    run on CUDA tensors.)"""

    def forward(self, x):
        if not (self.training and is_distributed()):
            return super().forward(x)
        y = x.to(self.weight.dtype)
        c = y.shape[1]
        dims = (0, 2, 3)
        sums = dist_nn.all_reduce(torch.cat(
            [y.sum(dims), y.new_full((1,), y.numel() // c)]))
        n = sums[c]
        mean = sums[:c] / n
        centred = y - mean[None, :, None, None]
        var = dist_nn.all_reduce(centred.square().sum(dims)) / n
        y = centred * torch.rsqrt(var + self.eps)[None, :, None, None]
        if self.affine:
            y = y * self.weight[None, :, None, None] + self.bias[None, :, None,
                                                                  None]
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                f = (self.momentum if self.momentum is not None
                     else 1.0 / float(self.num_batches_tracked))
                self.running_mean.mul_(1 - f).add_(mean, alpha=f)
                self.running_var.mul_(1 - f).add_(var * (n / (n - 1)),
                                                  alpha=f)
        return y.to(x.dtype)


def convert_batchnorm(module):
    """Make every BatchNorm2d in ``module`` a ``CrossRankBatchNorm2d`` in
    place, keeping its parameter and buffer tensors (an optimizer built on
    them stays valid). Returns ``module``."""
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.__class__ = CrossRankBatchNorm2d
    return module


def wrap(module, device):
    """``module`` (on ``device``) in ``DistributedDataParallel``: rank 0's
    parameters and buffers are broadcast to every rank, and the backward
    averages the gradients."""
    device = torch.device(device)
    return DistributedDataParallel(
        module, device_ids=[device] if device.type == "cuda" else None)


def unwrap(module):
    """The module inside a DDP wrapper (``module`` itself otherwise): what
    checkpoints save and what rank 0 validates with."""
    return module.module if isinstance(module, DistributedDataParallel) \
        else module
