"""The SFF and SP restore pipelines (counterpart of
``sstem_tpu/infer/pipeline.py``: ``SFFPipeline`` and ``SPPipeline``, on their
``packed_conv=False`` paths and, with ``packed_conv=True``, on their
fused-conv serving paths). ``SPPipeline`` is described at its class.

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
returns numpy results from the ``restore_stack*`` entry points. Both
constructors apply the matmul-precision policy (``config.py``): float32
runs at ``"highest"`` (TF32 off) unless the caller set a lower one.

With ``packed_conv=True`` the nets run as the serving forwards of
``models/serving.py`` (bf16, NHWC, the conv, pool, deconv and head-tail
kernels) on two-channel gray pairs end to end: [prev, next] into IFNet,
[degraded, interp] into FusionNet, [warped, interp] into UNetSFF, each net's
first conv pair-folded (exact on the replicated-gray input); the warp runs
once, on the one degraded channel, and ``warped`` stays single-channel.
"""

import copy
import logging

import numpy as np
import torch
import torch.nn.functional as F

from sstem_tpu_torch.config import (
    PARITY_DTYPE, SERVING_DTYPE, apply_matmul_precision,
)
from sstem_tpu_torch.infer.tiles import pad_to_multiple
from sstem_tpu_torch.kernels import serving_warp
from sstem_tpu_torch.models.layers import cast_conv_weights
from sstem_tpu_torch.models.serving import (
    fusionnet_serve,
    fusionnet_sp_serve,
    ifnet_serve,
    unet_sff_serve,
    unet_sp_serve,
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
        ``UNetSFF`` instances, or None for a stage the caller does not run
        (as the JAX pipeline takes ``flow_vars=None``: the interp CLI
        builds the interp stage alone, the fusion CLI the flow and fusion
        stages). They are moved to ``device`` and put in eval mode; without
        ``packed_conv`` their conv weights are cast to ``dtype`` in place
        (the serving forwards read float32 weights and keep bf16 copies of
        their own). A method that needs a missing model raises
        ``ValueError``.
      device: where the models run.
      dtype: compute dtype, ``config.PARITY_DTYPE`` (float32) or
        ``config.SERVING_DTYPE`` (bfloat16).
      pad: the reference's TEST.pad, a symmetric zero pad before the interp
        model and a crop after (``restore_stack`` path only).
      packed_conv: run the fused-conv serving forwards (bf16 only; the JAX
        package has no float32 packed path). False by default: the cuDNN
        path stays the default until a measurement on the card shows the
        fused path faster. The serving forwards target the reference
        FusionNet width (ngf 32); with a flow model of another width the
        pipeline is built on the cuDNN path, as the JAX pipeline sets
        ``packed_conv = False`` when ``ngf != 32``, and logs a warning.
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
        apply_matmul_precision()
        ngf = None if flow_model is None else \
            flow_model.down_1.conv_1[0].out_channels
        if packed_conv and ngf not in (None, 32):
            logging.getLogger(__name__).warning(
                "SFFPipeline: packed_conv=True serves the reference FusionNet "
                "width 32; this flow model is %d wide, so the pipeline runs "
                "on the cuDNN path", ngf)
            packed_conv = fused_head_tail = False
        self.device = torch.device(device)
        self.pad = pad
        self.packed_conv = packed_conv
        self.fused_head_tail = fused_head_tail
        models = []
        for m in (interp_model, flow_model, fusion_model):
            if m is not None:
                m = m.to(self.device).eval()
                if not packed_conv:
                    m = cast_conv_weights(m, dtype)
            models.append(m)
        self.interp_model, self.flow_model, self.fusion_model = models

    def _need(self, method, *names):
        """Raise ValueError naming the models that ``method`` needs and
        this pipeline was built without."""
        missing = [n for n in names if getattr(self, n) is None]
        if missing:
            raise ValueError(f"SFFPipeline.{method} needs {', '.join(missing)}, "
                             f"which this pipeline was built without")

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
        self._need("section", "interp_model", "flow_model", "fusion_model")
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
    def interpolate(self, prev_imgs, next_imgs, clip=True):
        """Interpolate sections from gray uint8 neighbours (N, H, W);
        returns (N, H, W) on the device, clamped to 0..1 unless ``clip`` is
        False (the reference interp inference casts pred * 255 to uint8
        without clipping)."""
        self._need("interpolate", "interp_model")
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
        return pred.clamp(0.0, 1.0) if clip else pred

    @torch.inference_mode()
    def restore(self, degraded_imgs, interp_imgs):
        """Correct degraded sections given interp images.

        Args: gray (N, H, W) uint8 or float images on the 0..255 scale.
        Returns a dict of device tensors: 'fused', 'warped', 'stitch' in
        0..1 and 'flow' (N, H, W, 2).
        """
        self._need("restore", "flow_model", "fusion_model")
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
        self._need("restore_stack", "interp_model", "flow_model",
                   "fusion_model")
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
        stitch] and float32 flow (B, Hp, Wp, 2), both on the device."""
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
    def restore_stack_scanned(self, stack, damaged_ids, chunk=4,
                              want_flow=True):
        """``restore_stack`` in groups of ``chunk`` sections, quantized on
        the device: one host->device copy of the edge-padded stack, and one
        device->host copy of uint8 images (and, with ``want_flow``, of the
        float32 flow) per group.

        The last group is filled to ``chunk`` from the end of the id list
        (or by repeating its last id) and duplicates are dropped from the
        result. Semantics match ``restore_stack`` to within 1 uint8 level
        (the interp hand-off skips its x255/255 round trip), except in a
        border band at sizes that are not multiples of 32, where this path
        keeps the network's interp on the padded canvas. TEST.pad is not
        supported here; use ``restore_stack``.

        Returns {id: {'interp', 'fused', 'warped', 'stitch'[, 'flow']}} with
        numpy uint8 images and float32 flow; without ``want_flow`` the flow
        stays on the device and is not returned.
        """
        self._need("restore_stack_scanned", "interp_model", "flow_model",
                   "fusion_model")
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
            if want_flow:
                flow = flow[:, :h, :w].cpu().numpy()
            for j, i in enumerate(grp):
                if i in results:
                    continue
                results[i] = {"interp": imgs[j, ..., 0],
                              "fused": imgs[j, ..., 1],
                              "warped": imgs[j, ..., 2],
                              "stitch": imgs[j, ..., 3]}
                if want_flow:
                    results[i]["flow"] = flow[j]
        return results

    def _replica(self, device):
        """This pipeline with its models copied to ``device`` (eval mode), so
        that the packed path's prepared weights belong to the copies."""
        pipe = copy.copy(self)
        pipe.device = device
        pipe.interp_model, pipe.flow_model, pipe.fusion_model = (
            copy.deepcopy(m).to(device).eval()
            for m in (self.interp_model, self.flow_model, self.fusion_model))
        return pipe

    @torch.inference_mode()
    def restore_stack_sharded(self, stack, damaged_ids, mesh, halo=256,
                              data_axis="data", space_axis="space"):
        """Mesh restore (``parallel.make_mesh``): sections data-parallel over
        ``data_axis``, each section's rows sharded over ``space_axis`` with
        ``halo`` rows exchanged between neighbouring slabs
        (``parallel.spatial_apply``). ``section`` runs on each slab, on a
        copy of the three models for each distinct mesh device (this
        pipeline's own on its device).

        The results equal the section function on the zero-extended canvas,
        cropped: the stack is padded with zeros to W % 32 == 0 and to a row
        count that gives every slab, halos included, a multiple of 32 rows
        (not ``restore_stack``'s edge pad). The JAX package's three accuracy
        regimes follow (``sstem_tpu/infer/pipeline.py``,
        ``restore_stack_sharded``): with ``n_space`` 1 and halo 0 the run is
        the single-device one on that canvas; a halo that covers the
        correction nets' receptive field (320 rows) makes the seams exact
        to a uint8 level; the interp (IFNet reaches 1/32 scale, and its
        align-corners upsampling is canvas-global) is approximate
        everywhere under row sharding, less so as the halo grows. The last
        group is filled by repeating its ids. TEST.pad is not supported.

        Returns {id: {'interp', 'fused', 'warped', 'stitch', 'flow'}} with
        numpy uint8 images and float32 flow.
        """
        from sstem_tpu_torch.parallel.mesh import canonical_device
        from sstem_tpu_torch.parallel.spatial import spatial_apply

        self._need("restore_stack_sharded", "interp_model", "flow_model",
                   "fusion_model")
        _check_interior(damaged_ids, len(stack))
        if self.pad:
            raise ValueError("restore_stack_sharded does not support "
                             "TEST.pad != 0; use restore_stack")
        if halo % 32:
            raise ValueError("halo must be a multiple of 32")
        n_dp, n_sp = mesh.shape[data_axis], mesh.shape[space_axis]
        stack = np.asarray(stack)
        _, h, w = stack.shape
        wp = -(-w // 32) * 32
        hp = -(-(h + 2 * halo) // (32 * n_sp)) * (32 * n_sp) - 2 * halo
        home = canonical_device(self.device)
        pipes = {d: self if d == home else self._replica(d)
                 for d in mesh.distinct_devices()}

        def section(xb):  # (N, rows, Wp, 3) on a mesh device -> (..., 5)
            interp, fused, warped, flow = pipes[xb.device].section(
                xb.permute(0, 3, 1, 2))
            return torch.cat([torch.stack([interp, fused, warped], -1), flow],
                             -1)

        dev_stack = torch.from_numpy(stack).to(self.device)
        ids = list(damaged_ids)
        results = {}
        for s in range(0, len(ids), n_dp):
            grp = ids[s:s + n_dp]
            if len(grp) < n_dp:
                grp = (grp * n_dp)[:n_dp]
            ix = torch.tensor(grp, device=self.device)
            x3 = torch.stack([dev_stack[ix - 1], dev_stack[ix + 1],
                              dev_stack[ix]], dim=-1).float() / 255.0
            x3 = F.pad(x3, (0, 0, 0, wp - w, 0, hp - h))
            out = spatial_apply(section, x3, mesh, halo, axis=space_axis,
                                batch_axis=data_axis)[:, :h, :w]
            i8, f8, w8 = (_level(out[..., k]) for k in range(3))
            stitch = torch.where(w8 >= 2, w8, i8)
            imgs = torch.stack([i8, f8, w8, stitch], -1).to(torch.uint8)
            imgs, flow = imgs.cpu().numpy(), out[..., 3:5].cpu().numpy()
            for j, i in enumerate(ids[s:s + n_dp]):
                results[i] = {"interp": imgs[j, ..., 0],
                              "fused": imgs[j, ..., 1],
                              "warped": imgs[j, ..., 2],
                              "stitch": imgs[j, ..., 3], "flow": flow[j]}
        return results


class SPPipeline:
    """SP quartet restoration (``sp_scripts_test/test_fusion.py:17-141``):
    sections 2 and 3 of a quartet are interpolated from sections 1 and 4
    (the two-frame IFNet, four sepconvs), each degraded section is denoised
    (UNetSP), and each interp and denoised pair is blended by its damage mask
    and fused (FusionNetSP):

        pred = fusion(vfi * (1 - m), denoise(deg) * m),   m = mask / 255

    Args:
      vfi_model: ``IFNet(kernel_size, n_frames=2)``.
      denoise_model, fusion_model: ``UNetSP`` and ``FusionNetSP`` (needed by
        ``restore`` only).
      device: where the models run.
      dtype: compute dtype, ``config.PARITY_DTYPE`` (float32) or
        ``config.SERVING_DTYPE`` (bfloat16). The IFNet's conv weights are
        cast to it in place, and without ``packed_conv`` the U-Nets' too.
      packed_conv: run the U-Nets as the fused-conv serving forwards of
        ``models/serving.py`` (bf16 only; they read float32 weights and
        keep bf16 copies of their own). The interp runs the IFNet module
        in ``dtype`` on both paths, as the JAX pipeline runs
        ``IFNet.apply``. False by default (the JAX package's automatic
        choice by backend is not carried over).

    Every public method runs under ``torch.inference_mode()`` on ``device``
    and returns device tensors.
    """

    def __init__(self, vfi_model, denoise_model=None, fusion_model=None,
                 device="cuda", dtype=PARITY_DTYPE, packed_conv=False):
        if dtype not in (PARITY_DTYPE, SERVING_DTYPE):
            raise ValueError(f"dtype must be {PARITY_DTYPE} or "
                             f"{SERVING_DTYPE}; got {dtype}")
        if packed_conv and dtype != SERVING_DTYPE:
            raise ValueError(
                f"packed_conv=True serves bfloat16 only (the JAX package has "
                f"no float32 packed path); got dtype={dtype}")
        if vfi_model.n_frames != 2:
            raise ValueError("SPPipeline interpolates two sections: it needs "
                             "IFNet(kernel_size, n_frames=2)")
        apply_matmul_precision()
        self.device = torch.device(device)
        self.packed_conv = packed_conv
        self.vfi_model = cast_conv_weights(vfi_model.to(self.device).eval(),
                                           dtype)
        nets = []
        for m in (denoise_model, fusion_model):
            if m is not None:
                m = m.to(self.device).eval()
                if not packed_conv:
                    m = cast_conv_weights(m, dtype)
            nets.append(m)
        self.denoise_model, self.fusion_model = nets

    def _to01(self, img):
        """(N, H, W) images on the 0..255 scale -> (N, H, W, 1) float32 in
        0..1 on the device."""
        return (torch.as_tensor(img, device=self.device).float()
                / 255.0)[..., None]

    @torch.inference_mode()
    def interp(self, img1, img4):
        """Sections 2 and 3 predicted from gray sections 1 and 4 (N, H, W)
        on the 0..255 scale: (N, H, W, 2) float32 in 0..1."""
        a, b = self._to01(img1), self._to01(img4)
        x = torch.cat([a, a, a, b, b, b], -1)
        x, (h, w) = pad_to_multiple(x, 32)
        pred = self.vfi_model(x.permute(0, 3, 1, 2))[:, :, :h, :w]
        return pred.permute(0, 2, 3, 1).float().clamp(0.0, 1.0)

    def _denoise(self, x):
        if self.packed_conv:
            return unet_sp_serve(self.denoise_model, x)
        y = self.denoise_model(x.permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1).float()

    def _fuse(self, a, b):
        if self.packed_conv:
            return fusionnet_sp_serve(self.fusion_model, a, b)
        y = self.fusion_model(a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1).float()

    @torch.inference_mode()
    def restore(self, img1, img4, deg2, deg3, mask2, mask3):
        """The quartet restore. All arguments gray (N, H, W) on the 0..255
        scale (masks 0 where the section is intact, 255 where damaged).

        Returns a dict of (N, H, W) float32 device tensors in 0..1:
        'pred1', 'pred2' (the fused sections 2 and 3), 'vfi1', 'vfi2' (the
        interp) and 'denoise1', 'denoise2'.
        """
        if self.denoise_model is None or self.fusion_model is None:
            raise ValueError("restore needs denoise_model and fusion_model")
        vfi = self.interp(img1, img4)
        vfi_pad, (h, w) = pad_to_multiple(vfi, 32)
        d2, d3, m2, m3 = (pad_to_multiple(self._to01(t), 32)[0]
                          for t in (deg2, deg3, mask2, mask3))
        den2 = self._denoise(d2)
        den3 = self._denoise(d3)
        p1 = self._fuse(vfi_pad[..., 0:1] * (1 - m2), den2 * m2)
        p2 = self._fuse(vfi_pad[..., 1:2] * (1 - m3), den3 * m3)

        def crop(t):
            return t[:, :h, :w, 0].clamp(0.0, 1.0)

        return {"pred1": crop(p1), "pred2": crop(p2),
                "vfi1": vfi[..., 0], "vfi2": vfi[..., 1],
                "denoise1": crop(den2), "denoise2": crop(den3)}
