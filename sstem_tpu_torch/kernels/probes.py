"""The micro-probes' kernels (counterparts of the Pallas kernels in
``tools/probe_dma_conv.py``: ``dma_copy``, and ``tools/probe_gather.py``:
``prim`` and ``prim_roll``).

  * ``tile_copy(x, ty)``: a copy of ``x`` staged through shared memory in
    slabs of ``ty`` leading rows (``csrc/probe_copy.cu``); it measures the
    copy bandwidth an asynchronous shared-memory staging reaches.
  * ``take_along_axis(src, idx, axis)``: ``jnp.take_along_axis`` of a 2-D
    float32 array by an int32 index array of the same shape
    (``csrc/probe_gather.cu``), with the JAX function's default fill mode:
    a negative index counts from the end, one out of range gives NaN.
  * ``roll_dynamic(src, shift)``: ``jnp.roll`` along axis 1 of a 2-D float32
    array by an int32 shift that lives on the device and is read in the
    kernel (``csrc/probe_roll.cu``).

CUDA tensors go through the kernels; CPU tensors through the plain versions
``tile_copy_plain``, ``take_along_axis_plain`` and ``roll_dynamic_plain``.

The gather and the roll each pick a kernel by shape (``design``): the
gather along axis 0 reads the source where the indices point, in a 2-D grid
of row bands by column tiles; the gather along axis 1 and the roll stage
each row in shared memory, one block a row, so they take rows of at most
``MAX_STAGED_COLS`` columns on the card. Each moves 16 bytes a thread where
cols % 4 == 0 and 4 bytes elsewhere.
"""

import torch

from sstem_tpu_torch.kernels import _build

# as csrc/probe_gather.cu and csrc/probe_roll.cu launch them: the axis-0
# gather's block of BAND_ROWS rows by TILE_GROUPS column groups, the staged
# kernels' ROW_THREADS threads a row, the columns a thread moves at once
# where cols % VECTOR_COLS == 0, and the longest staged row
BAND_ROWS, TILE_GROUPS, ROW_THREADS, VECTOR_COLS = 8, 32, 128, 4
MAX_STAGED_COLS = 56 * 1024


def design(axis, cols):
    """The kernel that serves a gather along ``axis`` (the roll: axis 1) of
    rows of ``cols`` columns and the bytes a thread moves at once:
    ('rows' or 'staged', 16 or 4)."""
    return ("rows" if axis == 0 else "staged",
            16 if cols % VECTOR_COLS == 0 else 4)


def _staged_fits(name, cols):
    if cols > MAX_STAGED_COLS:
        raise ValueError(f"{name} stages a row in shared memory and takes at "
                         f"most {MAX_STAGED_COLS} columns on the card; got "
                         f"{cols}")


def tile_copy_plain(x, ty=4):
    """Plain PyTorch version: ``x.clone()`` (``ty`` changes no value)."""
    del ty
    return x.clone()


def tile_copy(x, ty=4):
    """Copy ``x`` through shared memory, ``ty`` leading rows per slab.

    Args:
      x: a contiguous tensor of any dtype with at least one dimension.
      ty: rows of ``x.shape[0]`` per slab (the TPU probe's block height).

    Returns:
      A new tensor equal to ``x``. ``tile_copy.launches`` counts kernel
      launches.
    """
    if x.dim() < 1 or x.numel() == 0 or ty < 1:
        raise ValueError(f"tile_copy wants a non-empty array and ty >= 1; got "
                         f"{tuple(x.shape)}, ty={ty}")
    if x.device.type == "cpu":
        return tile_copy_plain(x, ty)
    device = _build.require_cuda("tile_copy", x)
    out = torch.empty_like(x)
    total = x.numel() * x.element_size()
    slab = ty * (total // x.shape[0])
    _build.launch("sstem_probe_copy", device, x.data_ptr(), out.data_ptr(),
                  total, slab)
    tile_copy.launches += 1
    return out


def take_along_axis_plain(src, idx, axis):
    """Plain PyTorch version: advanced indexing, a negative index counted
    from the end, NaN where the index is out of range."""
    extent = src.shape[axis]
    idx = torch.where(idx < 0, idx + extent, idx)
    safe = idx.long().clamp(0, extent - 1)
    if axis == 0:
        got = src[safe, torch.arange(src.shape[1], device=src.device)]
    else:
        got = src[torch.arange(src.shape[0], device=src.device)[:, None], safe]
    valid = (idx >= 0) & (idx < extent)
    return torch.where(valid, got, torch.full_like(got, float("nan")))


def _check_2d(name, src, other, other_dtype):
    if src.dim() != 2 or src.numel() == 0:
        raise ValueError(f"{name} wants a non-empty (rows, cols) array; got "
                         f"{tuple(src.shape)}")
    if src.dtype != torch.float32 or other.dtype != other_dtype:
        raise TypeError(f"{name} takes a float32 array and {other_dtype}; got "
                        f"{src.dtype}, {other.dtype}")
    if src.device != other.device:
        raise ValueError(f"{name}: inputs on different devices")


def take_along_axis(src, idx, axis):
    """``jnp.take_along_axis(src, idx, axis)`` for 2-D arrays.

    Args:
      src: (rows, cols) float32.
      idx: (rows, cols) int32, indices along ``axis``.
      axis: 0 or 1.

    Returns:
      (rows, cols) float32. ``take_along_axis.launches`` counts kernel
      launches.
    """
    _check_2d("take_along_axis", src, idx, torch.int32)
    if axis not in (0, 1):
        raise ValueError(f"take_along_axis: axis must be 0 or 1, got {axis}")
    if idx.shape != src.shape:
        raise ValueError(f"take_along_axis wants idx of src's shape "
                         f"{tuple(src.shape)}; got {tuple(idx.shape)}")
    if not src.is_cuda and src.device.type == "cpu":
        return take_along_axis_plain(src, idx, axis)
    device = _build.require_cuda("take_along_axis", src, idx)
    rows, cols = src.shape
    if axis == 1:
        _staged_fits("take_along_axis along axis 1", cols)
    out = torch.empty_like(src)
    _build.launch("sstem_probe_gather", device, src.data_ptr(),
                  idx.data_ptr(), out.data_ptr(), rows, cols, axis)
    take_along_axis.launches += 1
    return out


def roll_dynamic_plain(src, shift):
    """Plain PyTorch version: the source column of each output column by
    index arithmetic on the device-side shift (no host sync)."""
    cols = src.shape[1]
    j = torch.arange(cols, device=src.device)
    return src[:, torch.remainder(j - shift.reshape(()).long(), cols)]


def roll_dynamic(src, shift):
    """``jnp.roll(src, shift, axis=1)`` with the shift read on the device.

    Args:
      src: (rows, cols) float32.
      shift: a one-element int32 tensor on ``src``'s device.

    Returns:
      (rows, cols) float32. ``roll_dynamic.launches`` counts kernel launches.
    """
    _check_2d("roll_dynamic", src, shift, torch.int32)
    if shift.numel() != 1:
        raise ValueError(f"roll_dynamic wants a one-element shift; got "
                         f"{tuple(shift.shape)}")
    if not src.is_cuda and src.device.type == "cpu":
        return roll_dynamic_plain(src, shift)
    device = _build.require_cuda("roll_dynamic", src, shift)
    rows, cols = src.shape
    _staged_fits("roll_dynamic", cols)
    out = torch.empty_like(src)
    _build.launch("sstem_probe_roll", device, src.data_ptr(),
                  shift.data_ptr(), out.data_ptr(), rows, cols)
    roll_dynamic.launches += 1
    return out


tile_copy.launches = 0
take_along_axis.launches = 0
roll_dynamic.launches = 0
