"""Fold-line flow synthesis (counterpart of ``sstem_tpu/ops/flow.py``:
``gen_line``, ``gen_flow_np`` and ``gen_flow``; ``fold_flows`` makes a batch
of numpy flows).

A fold line ``y = k*x + b``, the signed distance ``d`` to it, and the
piecewise-linear displacement profile of the reference flow synthesizer
(``flow_synthesis.py:8-87``). ``flow2`` is the ground-truth unfolding flow.
``gen_flow_np`` is the exact float64 host version; ``gen_flow`` computes the
same fields in float32 tensors, with its parameters batched, so that a whole
batch of fold candidates is synthesized in one pass on the card.
"""

import math

import numpy as np
import torch

_MINA = 1e-9


def gen_line(p1, p2):
    """Line (slope, intercept) through two (row, col) points."""
    denom = p2[1] - p1[1]
    if denom == 0:
        denom = _MINA
    k = (p2[0] - p1[0]) / denom
    b = p1[0] - k * p1[1]
    return k, b


def gen_flow_np(height, width, k, b, line_width=5, fold_width=10, dis_k=0.1):
    """Returns (flow, flow2, mask): (H, W, 2), (H, W, 2) float32, (H, W)."""
    gx = np.tile(np.arange(width)[None, :], [height, 1]).astype(np.float64)
    gy = np.tile(np.arange(height)[:, None], [1, width]).astype(np.float64)
    dis = (k * gx - gy + b) / math.sqrt(k**2 + 1)

    sign = np.zeros_like(dis)
    sign[dis > 0] = 1
    sign[dis < 0] = -1

    dis_abs = np.abs(dis)
    mask = (dis_abs > line_width).astype(np.float64)

    mask_dis = (dis_abs >= line_width).astype(np.float64)
    mask_dis2 = (dis_abs >= fold_width).astype(np.float64)

    dis_width = fold_width - line_width
    slope = -dis_k
    intercept = dis_width - slope * line_width
    prof = np.maximum(slope * dis_abs + intercept, 0.0)

    d1 = prof * mask_dis + dis_abs * (1 - mask_dis)
    d2 = prof * mask_dis2 + dis_abs * (1 - mask_dis2)

    dis1 = d1 * sign
    dis2 = d2 * (-sign)

    k_t = 1.0 / _MINA if k == 0 else 1.0 / k
    angle = math.atan(k_t)
    sin_p, cos_p = math.sin(angle), math.cos(angle)

    flow = np.zeros((height, width, 2), dtype=np.float32)
    flow2 = np.zeros((height, width, 2), dtype=np.float32)
    if k > 0:
        flow[..., 0] = dis1 * cos_p
        flow[..., 1] = -dis1 * sin_p
        flow2[..., 0] = dis2 * cos_p
        flow2[..., 1] = -dis2 * sin_p
    else:
        flow[..., 0] = -dis1 * cos_p
        flow[..., 1] = dis1 * sin_p
        flow2[..., 0] = -dis2 * cos_p
        flow2[..., 1] = dis2 * sin_p
    return flow, flow2, mask.astype(np.float32)


def gen_flow(height, width, k, b, line_width=5.0, fold_width=10.0,
             dis_k=0.1, device=None):
    """Float32 flow synthesis; returns (flow, flow2, mask).

    The parameters are numbers or tensors of one batch shape S (0-d for a
    single fold); the results are (*S, H, W, 2), (*S, H, W, 2) and
    (*S, H, W), on ``device`` (by default the parameters' device).
    """
    params = [k, b, line_width, fold_width, dis_k]
    if device is None:
        device = next((p.device for p in params if torch.is_tensor(p)), "cpu")
    k, b, line_width, fold_width, dis_k = (
        torch.as_tensor(p, dtype=torch.float32, device=device)[..., None, None]
        for p in params)
    gx = torch.arange(width, dtype=torch.float32, device=device)
    gy = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    dis = (k * gx - gy + b) / torch.sqrt(k ** 2 + 1)

    sign = torch.sign(dis)
    dis_abs = torch.abs(dis)
    mask = (dis_abs > line_width).float()
    mask_dis = (dis_abs >= line_width).float()
    mask_dis2 = (dis_abs >= fold_width).float()

    dis_width = fold_width - line_width
    slope = -dis_k
    intercept = dis_width - slope * line_width
    prof = torch.clamp(slope * dis_abs + intercept, min=0.0)

    d1 = prof * mask_dis + dis_abs * (1 - mask_dis)
    d2 = prof * mask_dis2 + dis_abs * (1 - mask_dis2)
    dis1 = d1 * sign
    dis2 = -d2 * sign

    k_t = torch.where(k == 0, torch.full_like(k, 1.0 / _MINA),
                      1.0 / torch.where(k == 0, torch.ones_like(k), k))
    angle = torch.arctan(k_t)
    sin_p, cos_p = torch.sin(angle), torch.cos(angle)

    sgn = torch.where(k > 0, 1.0, -1.0)
    flow = torch.stack([sgn * dis1 * cos_p, -sgn * dis1 * sin_p], dim=-1)
    flow2 = torch.stack([sgn * dis2 * cos_p, -sgn * dis2 * sin_p], dim=-1)
    return flow, flow2, mask


def fold_flows(n, h, w, seed):
    """(n, h, w, 2) float32 ground-truth unfolding flows of random fold
    lines crossing the image from its left to its right edge (line width 8,
    fold width 40), made from ``seed``: realistic flows for the warp's
    checks and timings."""
    rng = np.random.default_rng(seed)
    flows = []
    for _ in range(n):
        k, b = gen_line((rng.uniform(0, h), 0.0), (rng.uniform(0, h), w - 1.0))
        flows.append(gen_flow_np(h, w, k, b, line_width=8, fold_width=40)[1])
    return np.stack(flows).astype(np.float32)
