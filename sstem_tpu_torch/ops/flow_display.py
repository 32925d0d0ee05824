"""Middlebury optical-flow visualization (copied from
``sstem_tpu/ops/flow_display.py``, which is numpy only; the port imports
nothing of the JAX package).

The standard Middlebury color-wheel encoding, as produced by the reference's
flow renderer (sff_scripts_unfolding/utils/flow_display.py:96-138):
magnitude-normalized flow mapped onto a 55-color wheel; colors with radius
<= 1 are whitened toward 1, out-of-range colors dimmed by 0.75; unknown
(>1e7) flow pixels are blacked.
"""

import numpy as np


def _make_color_wheel():
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    ncols = ry + yg + gc + cb + bm + mr
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:ry, 0] = 255
    wheel[0:ry, 1] = np.floor(255 * np.arange(ry) / ry)
    col += ry
    wheel[col:col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
    wheel[col:col + yg, 1] = 255
    col += yg
    wheel[col:col + gc, 1] = 255
    wheel[col:col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
    col += gc
    wheel[col:col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
    wheel[col:col + cb, 2] = 255
    col += cb
    wheel[col:col + bm, 2] = 255
    wheel[col:col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
    col += bm
    wheel[col:col + mr, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
    wheel[col:col + mr, 0] = 255
    return wheel


_WHEEL = _make_color_wheel()


def _compute_color(u, v):
    h, w = u.shape
    img = np.zeros((h, w, 3), np.uint8)
    nan_idx = np.isnan(u) | np.isnan(v)
    u = np.where(nan_idx, 0, u)
    v = np.where(nan_idx, 0, v)
    ncols = _WHEEL.shape[0]
    rad = np.sqrt(u**2 + v**2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1) + 1
    k0 = np.floor(fk).astype(int)
    k1 = k0 + 1
    k1[k1 == ncols + 1] = 1
    f = fk - k0
    for i in range(3):
        col0 = _WHEEL[k0 - 1, i] / 255.0
        col1 = _WHEEL[(k1 - 1) % ncols, i] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] *= 0.75
        img[:, :, i] = np.uint8(np.floor(255 * col * (1 - nan_idx)))
    return img


def flow_to_image(flow):
    """(H, W, 2) flow -> (H, W, 3) uint8 Middlebury rendering."""
    u = np.array(flow[:, :, 0], dtype=np.float64)
    v = np.array(flow[:, :, 1], dtype=np.float64)
    unknown = (np.abs(u) > 1e7) | (np.abs(v) > 1e7)
    u[unknown] = 0
    v[unknown] = 0
    rad = np.sqrt(u**2 + v**2)
    maxrad = max(-1, float(rad.max()) if rad.size else 0.0)
    u = u / (maxrad + np.finfo(float).eps)
    v = v / (maxrad + np.finfo(float).eps)
    img = _compute_color(u, v)
    img[np.repeat(unknown[:, :, None], 3, axis=2)] = 0
    return img


def dense_flow(flow):
    """(H, W, 2) flow -> its (H, W, 3) uint8 Middlebury rendering."""
    return flow_to_image(flow)
