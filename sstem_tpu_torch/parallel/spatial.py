"""Row sharding with halo exchange (counterpart of
``sstem_tpu/parallel/spatial.py``).

A section batch is cut into row slabs along a mesh axis; each slab takes
``halo`` rows from the slab above and the slab below, copied to its own
device (the JAX package exchanges them with ``ppermute`` inside
``shard_map``), and the model runs on each slab.

Boundary semantics, as in the JAX package: the image is first extended by
``halo`` zero rows above and below (the canvas), and the result equals
``apply_fn(canvas)`` cropped back, exactly for a model whose receptive-field
margin fits the halo. The outermost slabs take zero rows where they have no
neighbour, which is what ``ppermute`` leaves on a device that receives
nothing.
"""

import torch
import torch.nn.functional as F


def spatial_apply(apply_fn, image, mesh, halo, axis="space", batch_axis=None):
    """Apply a local model over a row-sharded image batch.

    Args:
      apply_fn: (N, h, W, C) -> (N, h, W, C_out), shape-preserving in the
        spatial dims, called with a tensor on the device where it must run.
      image: (N, H, W, C).
      mesh: ``parallel.Mesh`` holding ``axis``.
      halo: rows exchanged with each neighbour (at least the receptive-field
        margin for exactness); 0 skips the exchange.
      batch_axis: a mesh axis to split the batch over too (dp x sp:
        sections over 'data', rows over 'space').

    Returns (N, H, W, C_out) on the image's device, equal to ``apply_fn`` of
    the zero-extended canvas, cropped.
    """
    n = mesh.shape[axis]
    n_b = 1 if batch_axis is None else mesh.shape[batch_axis]
    h = image.shape[1]
    hc = h + 2 * halo
    hp = -(-hc // n) * n
    rows = hp // n
    if image.shape[0] % n_b:
        raise ValueError(f"batch of {image.shape[0]} does not split {n_b} ways")
    canvas = F.pad(image, (0, 0, 0, 0, halo, halo + hp - hc))
    out = []
    for b, xb in enumerate(canvas.chunk(n_b)):
        index = {} if batch_axis is None else {batch_axis: b}
        slabs = [xb[:, i * rows:(i + 1) * rows] for i in range(n)]
        outs = []
        for i, slab in enumerate(slabs):
            device = mesh.device(**index, **{axis: i})
            x = slab.to(device)
            if halo:
                edge = x.new_zeros(x.shape[0], halo, *x.shape[2:])
                above = slabs[i - 1][:, -halo:].to(device) if i else edge
                below = slabs[i + 1][:, :halo].to(device) if i < n - 1 else edge
                x = torch.cat([above, x, below], dim=1)
                outs.append(apply_fn(x)[:, halo:-halo])
            else:
                outs.append(apply_fn(x))
        out.append(torch.cat([o.to(image.device) for o in outs], dim=1))
    return torch.cat(out)[:, halo:halo + h]
