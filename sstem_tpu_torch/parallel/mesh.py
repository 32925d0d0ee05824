"""Device meshes and batch sharding (counterpart of
``sstem_tpu/parallel/mesh.py``).

The JAX package runs one controller over all local devices: a
``jax.sharding.Mesh`` with a 'data' axis (batch parallelism) and a 'space'
axis (row-sharded sections, ``parallel/spatial.py``). The port keeps that
shape in one process: a mesh is a grid of ``torch.device``s, and data moves
between them as tensor copies. No ``torch.distributed`` process group is
made.
"""

import copy

import torch

AXES = ("data", "space")


def canonical_device(device):
    """``torch.device(device)``, with the current CUDA index filled in for a
    bare 'cuda' (so that equal devices compare equal)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """An (n_data, n_space) grid of devices over the axes ('data', 'space').

    ``shape`` maps each axis name to its size, as a JAX mesh's does, so code
    written against ``mesh.shape[axis]`` reads the same in both packages.
    """

    axis_names = AXES

    def __init__(self, devices):
        self.devices = tuple(tuple(row) for row in devices)
        self.shape = {"data": len(self.devices), "space": len(self.devices[0])}
        self.size = self.shape["data"] * self.shape["space"]

    def device(self, **index):
        """The device at ``index`` (axis name -> position); an axis left out
        takes position 0."""
        return self.devices[index.get("data", 0)][index.get("space", 0)]

    def distinct_devices(self):
        """The mesh's devices without repeats, in row-major order."""
        return list(dict.fromkeys(d for row in self.devices for d in row))


def make_mesh(n_data=None, n_space=1, devices=None):
    """Mesh over ('data', 'space'); by default every visible CUDA device on
    the 'data' axis.

    With no CUDA device and no ``devices``, it raises: a mesh never falls
    back to the CPU. A device may repeat in ``devices``: that is how one
    process on the CPU stands for the JAX tests' 8 virtual devices
    (``devices=["cpu"] * 8``; torch has one 'cpu' device), and how one card
    runs a 2 x 2 mesh (``devices=["cuda:0"] * 4``). Slabs on a repeated
    device run one after another on it.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass devices= to build "
                "a mesh over other devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [canonical_device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_space
    if n_data < 1 or n_space < 1 or n_data * n_space > len(devices):
        raise ValueError(f"need {n_data}x{n_space} devices, have {len(devices)}")
    return Mesh([devices[i * n_space:(i + 1) * n_space] for i in range(n_data)])


def shard_batch(batch, mesh):
    """Split dim 0 of ``batch`` into ``mesh.shape['data']`` equal parts and
    put part i on the device at (data=i, space=0). Returns the parts in
    order. (A JAX batch sharded on 'data' is also replicated over 'space';
    here each part lives once, on the first device of its row.)"""
    n = mesh.shape["data"]
    if batch.shape[0] % n:
        raise ValueError(f"batch of {batch.shape[0]} does not split {n} ways")
    return [part.to(mesh.device(data=i))
            for i, part in enumerate(batch.chunk(n))]


def replicate(module, mesh):
    """{device: an eval-mode copy of ``module`` on that device}, one copy per
    distinct device of the mesh."""
    return {d: copy.deepcopy(module).to(d).eval()
            for d in mesh.distinct_devices()}
