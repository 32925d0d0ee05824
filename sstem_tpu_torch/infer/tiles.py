"""Full-section inference: one shot, or halo-padded tiles (counterpart of
``sstem_tpu/infer/tiles.py``).

  * ``infer_full`` pads to the model stride and runs one call.
  * ``infer_tiled`` cuts the section into halo-padded tiles of one shape and
    runs them in batches: activation memory stays bounded for sections of
    any size, and with a mesh each batch is split over its 'data' axis.

Images are (N, H, W, C) for ``pad_to_multiple`` and ``infer_full``, one
(H, W, C) section for the tile functions, as in the JAX package.
"""

import torch
import torch.nn.functional as F

from sstem_tpu_torch.config import apply_matmul_precision

# numpy's pad modes (the JAX package's names) -> F.pad's
_PAD_MODES = {"edge": "replicate", "constant": "constant"}


def _pad_hw(x, top, bottom, left, right, mode):
    """Pad dims 1 and 2 of (N, H, W, C) in numpy's ``mode`` (zeros for
    'constant')."""
    if mode not in _PAD_MODES:
        raise ValueError(f"pad mode {mode!r} is not one of {sorted(_PAD_MODES)}")
    x = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom),
              mode=_PAD_MODES[mode])
    return x.permute(0, 2, 3, 1)


def pad_to_multiple(x, multiple, mode="edge"):
    """Pad the spatial dims of (N, H, W, C) up to a stride multiple.

    Returns (padded, (h, w)) with the original size. Edge mode by default,
    as the JAX pipeline pads (a zero pad would differ over the receptive
    field).
    """
    n, h, w, c = x.shape
    hp = -(-h // multiple) * multiple
    wp = -(-w // multiple) * multiple
    if hp == h and wp == w:
        return x, (h, w)
    return _pad_hw(x, 0, hp - h, 0, wp - w, mode), (h, w)


def infer_full(apply_fn, image, multiple=32):
    """Run ``apply_fn`` on a full (N, H, W, C) image, padded to the stride."""
    apply_matmul_precision()
    padded, (h, w) = pad_to_multiple(image, multiple)
    return apply_fn(padded)[:, :h, :w, :]


def tile_image(image, tile=512, halo=64, mode="constant"):
    """(H, W, C) -> ((T, tile + 2 halo, tile + 2 halo, C) tiles, grid), grid
    = (ny, nx, h, w), tiles in row-major order.

    Zero padding by default, so border tiles see what the zero-padded
    convolutions of a full pass see: a tiled pass equals a full one for a
    model whose receptive field fits the halo.
    """
    h, w, c = image.shape
    ny = -(-h // tile)
    nx = -(-w // tile)
    padded = _pad_hw(image[None], halo, ny * tile - h + halo, halo,
                     nx * tile - w + halo, mode)[0]
    size = tile + 2 * halo
    tiles = [padded[iy * tile:iy * tile + size, ix * tile:ix * tile + size]
             for iy in range(ny) for ix in range(nx)]
    return torch.stack(tiles), (ny, nx, h, w)


def untile(tiles_out, grid, halo=64):
    """Crop the tiles' centres and reassemble them to (H, W, C_out)."""
    ny, nx, h, w = grid
    t = tiles_out.shape[1] - 2 * halo
    centers = tiles_out[:, halo:halo + t, halo:halo + t, :]
    rows = [torch.cat([centers[iy * nx + ix] for ix in range(nx)], dim=1)
            for iy in range(ny)]
    return torch.cat(rows, dim=0)[:h, :w, :]


def infer_tiled(apply_fn, image, tile=512, halo=64, batch=4, mesh=None,
                mode="constant"):
    """Tiled inference of one (H, W, C) section.

    ``apply_fn``: (B, tile + 2 halo, tile + 2 halo, C) -> the same with
    C_out channels, called once per batch of ``batch`` tiles (the last batch
    filled by repeating its last tile; the fill is dropped). With ``mesh``
    (``parallel.make_mesh``), ``batch`` is at least the mesh's device count,
    each batch is split along the mesh's 'data' axis (``shard_batch``), and
    ``apply_fn`` is called once per part with that part on its device (see
    ``parallel.replicate`` for a module on each); the outputs come back to
    the image's device in order.
    """
    from sstem_tpu_torch.parallel.mesh import shard_batch

    apply_matmul_precision()
    tiles, grid = tile_image(image, tile, halo, mode)
    n = tiles.shape[0]
    if mesh is not None:
        batch = max(batch, mesh.size)
    outs = []
    for s in range(0, n, batch):
        chunk = tiles[s:s + batch]
        pad_n = batch - chunk.shape[0]
        if pad_n:
            chunk = torch.cat([chunk, chunk[-1:].expand(pad_n, *chunk.shape[1:])])
        if mesh is None:
            out = apply_fn(chunk)
        else:
            parts = [apply_fn(part) for part in shard_batch(chunk, mesh)]
            out = torch.cat([p.to(image.device) for p in parts])
        outs.append(out[:batch - pad_n])
    return untile(torch.cat(outs), grid, halo)
