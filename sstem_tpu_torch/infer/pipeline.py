"""The SFF restore pipeline (counterpart of ``sstem_tpu/infer/pipeline.py``:
``SFFPipeline``, on its ``packed_conv=False`` path and, with
``packed_conv=True``, on its fused-conv serving path).

For each damaged section k of a (Z, H, W) uint8 stack:

  1. IFNet interpolates section k from sections k-1 and k+1 (two sepconvs);
  2. FusionNet predicts a 2-channel unfolding flow from
     [degraded x3, interp x3];
  3. the degraded section is warped backward by the flow (zero border);
  4. UNetSFF fuses [warped x3, interp x3];
  5. the stitch composite ``m = warped8 >= 2; interp8*(1-m) + warped8*m`` is
     formed at 255 scale and every image is floor-quantized to uint8.

Reference semantics (``sff_scripts_fusion/inference.py:112-201``): eval-mode
models, inputs /255, the zero-border warp, the stitch threshold of 2 levels.
Every public method runs under ``torch.inference_mode()`` on ``device``, and
returns numpy results from the ``restore_stack*`` entry points.

With ``packed_conv=True`` the nets run as the serving forwards of
``models/serving.py`` (bf16, NHWC, the conv, pool, deconv and head-tail
kernels) on two-channel gray pairs end to end: [prev, next] into IFNet,
[degraded, interp] into FusionNet, [warped, interp] into UNetSFF, each net's
first conv pair-folded (exact on the replicated-gray input); the warp runs
once, on the one degraded channel, and ``warped`` stays single-channel.
"""

import numpy as np
import torch
import torch.nn.functional as F

from sstem_tpu_torch.config import PARITY_DTYPE, SERVING_DTYPE
from sstem_tpu_torch.infer.tiles import pad_to_multiple
from sstem_tpu_torch.kernels import serving_warp
from sstem_tpu_torch.models.layers import set_compute_dtype
from sstem_tpu_torch.models.serving import (
    fusionnet_serve,
    ifnet_serve,
    unet_sff_serve,
)


def _check_interior(damaged_ids, z):
    """Damaged sections need both z-neighbours; boundary ids are rejected."""
    bad = [int(i) for i in damaged_ids if not 0 < int(i) < z - 1]
    if bad:
        raise ValueError(
            f"damaged_ids {bad} lack a z-neighbor in a {z}-section stack; "
            "interp needs sections k-1 and k+1 (pad the stack or drop the "
            "boundary sections)")


def _gray6(a, b):
    """Two gray (N, H, W) images -> (N, 6, H, W) replicated-channel input."""
    return torch.stack([a, a, a, b, b, b], dim=1)


def _level(x):
    """Unit-range image -> its uint8 level as a float, floor(clip(x)*255)."""
    return torch.floor(x.clamp(0.0, 1.0) * 255.0)


class SFFPipeline:
    """interp (KPN) -> unfolding flow -> warp -> fusion U-Net -> stitch.

    Args:
      interp_model, flow_model, fusion_model: ``IFNet``, ``FusionNet`` and
        ``UNetSFF`` instances. They are moved to ``device`` and put in eval
        mode; without ``packed_conv`` their conv weights are cast to
        ``dtype`` in place (the serving forwards read float32 weights and
        keep bf16 copies of their own).
      device: where the models run.
      dtype: compute dtype, ``config.PARITY_DTYPE`` (float32) or
        ``config.SERVING_DTYPE`` (bfloat16).
      pad: the reference's TEST.pad, a symmetric zero pad before the interp
        model and a crop after (``restore_stack`` path only).
      packed_conv: run the fused-conv serving forwards (bf16 only; the JAX
        package has no float32 packed path). False by default: the cuDNN
        path stays the default until a measurement on the card shows the
        fused path faster.
      fused_head_tail: with ``packed_conv``, run the IFNet head tails on the
        ``head_tail`` kernel (the JAX ``SSTEM_FUSED_HEAD_TAIL=1``) instead of
        cuDNN's upsample and conv.
    """

    def __init__(self, interp_model, flow_model, fusion_model, device,
                 dtype=PARITY_DTYPE, pad=0, packed_conv=False,
                 fused_head_tail=False):
        if packed_conv and dtype != SERVING_DTYPE:
            raise ValueError(
                f"packed_conv=True serves bfloat16 only (the JAX package has "
                f"no float32 packed path); got dtype={dtype}")
        if fused_head_tail and not packed_conv:
            raise ValueError("fused_head_tail needs packed_conv=True")
        self.device = torch.device(device)
        self.pad = pad
        self.packed_conv = packed_conv
        self.fused_head_tail = fused_head_tail
        models = [m.to(self.device).eval()
                  for m in (interp_model, flow_model, fusion_model)]
        if not packed_conv:
            models = [set_compute_dtype(m, dtype) for m in models]
        self.interp_model, self.flow_model, self.fusion_model = models

    def _to01(self, img):
        return torch.as_tensor(img, device=self.device).float() / 255.0

    def _interp(self, x2):
        """Packed path: IFNet on an (N, H, W, 2) [prev, next] pair in 0..1 ->
        (N, H, W) float32."""
        return ifnet_serve(self.interp_model, x2,
                           fused_head_tail=self.fused_head_tail)[..., 0]

    def _restore_packed(self, x2):
        """Packed path: (N, H, W, 2) [degraded, interp] -> (pred (N, H, W),
        flow (N, H, W, 2) f32, warped (N, H, W) f32)."""
        flow = fusionnet_serve(self.flow_model, x2).float()
        warped = serving_warp(x2[..., 0:1].contiguous(), flow)
        fused_in = torch.cat([warped, x2[..., 1:2]], -1)
        pred = unet_sff_serve(self.fusion_model, fused_in).float()
        return pred[..., 0], flow, warped[..., 0]

    def _restore(self, xr):
        """(N, 6, H, W) [degraded x3, interp x3] -> (pred (N, 1, H, W),
        flow (N, H, W, 2) f32, warped (N, H, W, 3) f32)."""
        flow = self.flow_model(xr).float().permute(0, 2, 3, 1).contiguous()
        # the degraded channels are gray replicated x3: warp once
        warped = serving_warp(xr[:, 0, :, :, None].contiguous(), flow)
        warped = warped.expand(-1, -1, -1, 3)
        fused_in = torch.cat([warped.permute(0, 3, 1, 2), xr[:, 3:6]], dim=1)
        return self.fusion_model(fused_in), flow, warped

    @torch.inference_mode()
    def section(self, x3):
        """Restore on a [prev, next, degraded] stack (N, 3, H, W) in 0..1.

        Returns float32 (interp, fused, warped) (N, H, W) and flow
        (N, H, W, 2), before clipping and quantization.
        """
        if self.packed_conv:
            interp = self._interp(torch.stack([x3[:, 0], x3[:, 1]], -1))
            interp = interp.clamp(0.0, 1.0)
            pred, flow, warped = self._restore_packed(
                torch.stack([x3[:, 2], interp], -1))
            return interp, pred, warped, flow
        interp = self.interp_model(_gray6(x3[:, 0], x3[:, 1]))[:, 0]
        interp = interp.clamp(0.0, 1.0).float()
        pred, flow, warped = self._restore(_gray6(x3[:, 2], interp))
        return interp, pred[:, 0].float(), warped.mean(-1), flow

    @torch.inference_mode()
    def interpolate(self, prev_imgs, next_imgs):
        """Interpolate sections from gray uint8 neighbours (N, H, W);
        returns (N, H, W) in 0..1 on the device."""
        if self.packed_conv:
            x = torch.stack([self._to01(prev_imgs), self._to01(next_imgs)], -1)
        else:
            x = _gray6(self._to01(prev_imgs), self._to01(next_imgs))
            x = x.permute(0, 2, 3, 1)
        if self.pad:
            p = self.pad
            x = F.pad(x, (0, 0, p, p, p, p))
        x, (h, w) = pad_to_multiple(x, 32)
        if self.packed_conv:
            pred = self._interp(x)[:, :h, :w]
        else:
            pred = self.interp_model(x.permute(0, 3, 1, 2))[:, 0, :h, :w]
        if self.pad:
            pred = pred[:, self.pad:-self.pad, self.pad:-self.pad]
        return pred.clamp(0.0, 1.0)

    @torch.inference_mode()
    def restore(self, degraded_imgs, interp_imgs):
        """Correct degraded sections given interp images.

        Args: gray (N, H, W) uint8 or float images on the 0..255 scale.
        Returns a dict of device tensors: 'fused', 'warped', 'stitch' in
        0..1 and 'flow' (N, H, W, 2).
        """
        if self.packed_conv:
            x = torch.stack([self._to01(degraded_imgs),
                             self._to01(interp_imgs)], -1)
            x, (h, w) = pad_to_multiple(x, 32)
            pred, flow, warped = self._restore_packed(x)
            pred = pred[:, :h, :w].clamp(0.0, 1.0)
            warped_g = warped[:, :h, :w].clamp(0.0, 1.0)
        else:
            x = _gray6(self._to01(degraded_imgs), self._to01(interp_imgs))
            x, (h, w) = pad_to_multiple(x.permute(0, 2, 3, 1), 32)
            pred, flow, warped = self._restore(x.permute(0, 3, 1, 2))
            pred = pred[:, 0, :h, :w].clamp(0.0, 1.0)
            warped_g = warped[:, :h, :w].mean(-1).clamp(0.0, 1.0)
        # stitch at uint8 scale with no /255*255 round trip (which would drop
        # a level about half the time); each level returns centred at
        # (k+0.5)/255 so floor(x*255) recovers k
        w8 = torch.floor(warped_g * 255.0)
        i8 = torch.floor(torch.as_tensor(interp_imgs, device=self.device)
                         .float().clamp(0.0, 255.0))
        stitch8 = torch.where(w8 >= 2, w8, i8)
        return {"fused": pred, "flow": flow[:, :h, :w], "warped": warped_g,
                "stitch": (stitch8 + 0.5) / 255.0}

    @torch.inference_mode()
    def restore_stack(self, stack, damaged_ids, chunk=1):
        """Restore damaged sections of a (Z, H, W) uint8 stack, ``chunk`` at
        a time, through ``interpolate`` then ``restore``.

        Returns {id: {'interp', 'fused', 'warped', 'stitch', 'flow'}} with
        numpy uint8 images and float32 flow.
        """
        _check_interior(damaged_ids, len(stack))
        dev_stack = torch.as_tensor(np.asarray(stack), device=self.device)
        results = {}
        for s in range(0, len(damaged_ids), chunk):
            ids = damaged_ids[s:s + chunk]
            if len(ids) < chunk and s > 0:
                ids = damaged_ids[len(damaged_ids) - chunk:]  # keep the shape
            results.update(self._restore_ids(dev_stack, ids))
        return results

    def _restore_ids(self, stack, ids):
        prev_ = stack[[i - 1 for i in ids]]
        next_ = stack[[i + 1 for i in ids]]
        interp = self.interpolate(prev_, next_)
        out = self.restore(stack[list(ids)], interp * 255.0)
        host = {k: torch.floor(v * 255).to(torch.uint8).cpu().numpy()
                for k, v in (("interp", interp), ("fused", out["fused"]),
                             ("warped", out["warped"]), ("stitch", out["stitch"]))}
        flow = out["flow"].cpu().numpy()
        return {i: {**{k: v[j] for k, v in host.items()}, "flow": flow[j]}
                for j, i in enumerate(ids)}

    def _restore_group(self, stack_p, grp):
        """One group on the device: neighbour gather, restore, stitch and
        quantization. Returns uint8 (B, Hp, Wp, 4) [interp, fused, warped,
        stitch] and float32 flow (B, Hp, Wp, 2)."""
        ix = torch.tensor(grp, device=self.device)
        x3 = torch.stack([stack_p[ix - 1], stack_p[ix + 1], stack_p[ix]],
                         dim=1).float() / 255.0
        interp, fused, warped, flow = self.section(x3)
        i8 = _level(interp)
        w8 = _level(warped)
        m = (w8 >= 2).float()
        stitch = i8 * (1 - m) + w8 * m
        imgs = torch.stack([i8, _level(fused), w8, stitch], dim=-1)
        return imgs.to(torch.uint8), flow

    @torch.inference_mode()
    def restore_stack_scanned(self, stack, damaged_ids, chunk=4):
        """``restore_stack`` in groups of ``chunk`` sections, quantized on
        the device: one host->device copy of the edge-padded stack, and one
        device->host copy of uint8 images (and flow) per group.

        The last group is filled to ``chunk`` from the end of the id list
        (or by repeating its last id) and duplicates are dropped from the
        result. Semantics match ``restore_stack`` to within 1 uint8 level
        (the interp hand-off skips its x255/255 round trip), except in a
        border band at sizes that are not multiples of 32, where this path
        keeps the network's interp on the padded canvas. TEST.pad is not
        supported here; use ``restore_stack``.

        Returns {id: {'interp', 'fused', 'warped', 'stitch', 'flow'}} with
        numpy uint8 images and float32 flow.
        """
        if self.pad:
            raise ValueError("restore_stack_scanned does not support "
                             "TEST.pad != 0; use restore_stack")
        stack = np.asarray(stack)
        z, h, w = stack.shape
        _check_interior(damaged_ids, z)
        hp = -(-h // 32) * 32
        wp = -(-w // 32) * 32
        stack_p = np.pad(stack, [(0, 0), (0, hp - h), (0, wp - w)], mode="edge")
        groups = []
        for s in range(0, len(damaged_ids), chunk):
            grp = list(damaged_ids[s:s + chunk])
            if len(grp) < chunk:
                grp = (list(damaged_ids[-chunk:]) if len(damaged_ids) >= chunk
                       else grp + [grp[-1]] * (chunk - len(grp)))
            groups.append(grp)
        dev_stack = torch.from_numpy(stack_p).to(self.device)
        results = {}
        for grp in groups:
            imgs, flow = self._restore_group(dev_stack, grp)
            imgs = imgs[:, :h, :w].cpu().numpy()
            flow = flow[:, :h, :w].cpu().numpy()
            for j, i in enumerate(grp):
                if i in results:
                    continue
                results[i] = {"interp": imgs[j, ..., 0],
                              "fused": imgs[j, ..., 1],
                              "warped": imgs[j, ..., 2],
                              "stitch": imgs[j, ..., 3],
                              "flow": flow[j]}
        return results
