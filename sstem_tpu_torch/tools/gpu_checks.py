"""The card's correctness gate: the port's CUDA kernels against their plain
PyTorch versions, on the card, at the serving and training shapes
(counterpart of ``tools/tpu_checks.py``, which holds the Pallas kernels
against XLA oracles and writes ``TPU_CHECKS.json``).

    python -m sstem_tpu_torch.tools.gpu_checks [--out GPU_CHECKS.json]

Writes ``{case: {"max_abs_err", "tol", "ok"}, "all_ok": bool}`` to
``--out`` (by default ``GPU_CHECKS.json`` at the root of the checkout),
prints ``{"gpu_checks": "pass" | "FAIL", "n": cases}`` and exits 0, or 1
when a case fails; without a card it prints one ``gpu_unavailable`` line
and exits 2, and on an error one ``error`` line and exits 2, as the JAX
tool does.

The cases are the JAX tool's, by name, shape and tolerance (``CASES``):
the kernel side is always the port's wrapper on the card, the oracle the
kernel's plain version on the same card, and each bf16 kernel output is
held against the plain version on the float32 inputs, as the JAX case
holds its kernel against the float32 XLA reference. Three departures:

  * ``ifnet_packed_vs_reference_rel`` holds the JAX ``packed=True`` IFNet
    twin (a TPU layout the port does not have) against the module. Its
    place is taken by ``ifnet_serve_vs_module_nrmse``:
    ``models.serving.ifnet_serve`` (bf16, the port's kernels) against the
    float32 ``IFNet`` module at 1 x 512^2 x 6, NRMSE of the module
    output's std, bound 0.05: the bound ``tests/test_serving.py`` sets
    between the JAX serving forwards (bf16) and flax. bf16 alone moves
    this output that far: at these seeded weights the port's own bf16
    module reads 0.031 from the float32 one on the CPU, and the serving
    forward's plain versions 0.037;
  * ``serving_warp_1280`` is added: the warp kernel at 4 x 1280^2 on fold
    flows against its plain version (1e-6), since every restore runs it;
  * ``packed_conv3x3_narrow_out_32to1_1280`` and
    ``packed_conv3x3_narrow_in_1to64_1280`` are added: conv3x3's two narrow
    designs at a full-width narrow shape of the packed paths (the SFF head
    32 -> 1, the SP gray first conv 1 -> 64), with the packed convs' 8e-2,
    since every packed restore runs them and the JAX tool's cases (C 32
    and 64) reach neither.
"""

import argparse
import json
import os
import sys
import traceback

import torch

from sstem_tpu_torch.tools._timing import card_missing, generator, policy

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
# (h, w, c, k) of the sepconv forward cases: W = 251 and 96 reach the
# `simple` design, the others `blocked`
SEPCONV_FWD_SHAPES = ((1280, 1280, 1, 51), (256, 251, 3, 51),
                      (160, 1280, 1, 51), (64, 96, 1, 5))
# (c, w) of the conv3x3 cases; H = W but for 904 (328 rows)
CONV_CASES = ((32, 1280), (64, 640), (32, 904))
# conv3x3's narrow designs: case -> (cin, cout), at 1 x 1280^2
NARROW_CONV_CASES = {"packed_conv3x3_narrow_out_32to1_1280": (32, 1),
                     "packed_conv3x3_narrow_in_1to64_1280": (1, 64)}
K = 51
CASES = {
    **{f"sepconv_fwd_{h}x{w}_c{c}_k{k}": 1e-4
       for h, w, c, k in SEPCONV_FWD_SHAPES},
    "sepconv_fwd_bf16maps_1280": 5e-2,
    "sepconv_bwd_dv_256": 1e-4,
    "sepconv_bwd_dh_256": 1e-4,
    "sepconv_grad_dv_vs_autodiff": 5e-3,
    "sepconv_grad_dh_vs_autodiff": 5e-3,
    "ifnet_serve_vs_module_nrmse": 0.05,
    **{f"packed_conv3x3_c{c}_{w}": 8e-2 for c, w in CONV_CASES},
    **{name: 8e-2 for name in NARROW_CONV_CASES},
    "packed_deconv_64to32_640": 8e-2,
    "packed_maxpool_1280": 1e-2,
    "head_tail_fused_640_k51": 2e-2,
    "serving_warp_1280": 1e-6,
}


def _err(got, want):
    return float((got.float() - want.float()).abs().max())


def _sepconv_cases(randn):
    from sstem_tpu_torch.kernels import (
        sepconv_planar, sepconv_planar_bwd, sepconv_planar_bwd_plain,
        sepconv_planar_plain)

    out = {}
    for h, w, c, k in SEPCONV_FWD_SHAPES:
        im = randn((1, c, h + k - 1, w + k - 1))
        v, hk = randn((1, k, h, w)) / k, randn((1, k, h, w)) / k
        out[f"sepconv_fwd_{h}x{w}_c{c}_k{k}"] = _err(
            sepconv_planar(im, v, hk), sepconv_planar_plain(im, v, hk))

    # bf16 tap maps (the serving configuration), float32 accumulation
    im = randn((1, 1, 1280 + K - 1, 1280 + K - 1))
    v = (randn((1, K, 1280, 1280)) / K).to(torch.bfloat16)
    hk = (randn((1, K, 1280, 1280)) / K).to(torch.bfloat16)
    out["sepconv_fwd_bf16maps_1280"] = _err(
        sepconv_planar(im, v, hk),
        sepconv_planar_plain(im, v.float(), hk.float()))

    h = w = 256
    im = randn((1, 1, h + K - 1, w + K - 1))
    v, hk = randn((1, K, h, w)) / K, randn((1, K, h, w)) / K
    g = randn((1, 1, h, w))
    got = sepconv_planar_bwd(im, v, hk, g)
    want = sepconv_planar_bwd_plain(im, v, hk, g)
    out["sepconv_bwd_dv_256"] = _err(got[0], want[0])
    out["sepconv_bwd_dh_256"] = _err(got[1], want[1])

    # the autograd.Function against autograd through the plain version
    v.requires_grad_(True)
    hk.requires_grad_(True)
    grads = [torch.autograd.grad((fn(im, v, hk) ** 2).sum(), (v, hk))
             for fn in (sepconv_planar, sepconv_planar_plain)]
    out["sepconv_grad_dv_vs_autodiff"] = _err(grads[0][0], grads[1][0])
    out["sepconv_grad_dh_vs_autodiff"] = _err(grads[0][1], grads[1][1])
    return out


@torch.inference_mode()
def _ifnet_case(device, seed):
    from sstem_tpu_torch.models import IFNet
    from sstem_tpu_torch.models.serving import ifnet_serve

    g = torch.Generator().manual_seed(seed)
    model = IFNet(K, generator=g).to(device).eval()
    x = torch.rand((1, 512, 512, 6), generator=g).to(device)
    want = model(x.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1)
    got = ifnet_serve(model, x)
    want = want.double()
    nrmse = ((got.double() - want) ** 2).mean().sqrt() / want.std()
    return {"ifnet_serve_vs_module_nrmse": float(nrmse)}


@torch.inference_mode()
def _packed_cases(randn):
    from sstem_tpu_torch.kernels import (
        conv3x3_fused, conv3x3_fused_plain, deconv2x_fused,
        deconv2x_fused_plain, fold_affine, head_tail, head_tail_plain, pool2x,
        pool2x_plain)

    bf16 = torch.bfloat16
    out = {}
    for c, w in CONV_CASES:
        x = randn((1, 328 if w == 904 else w, w, c))
        wk = randn((3, 3, c, c)) / (3 * c ** 0.5)
        scale, shift = fold_affine(c, randn((c,)) * 0.1)
        out[f"packed_conv3x3_c{c}_{w}"] = _err(
            conv3x3_fused(x.to(bf16), wk.to(bf16), scale, shift, "leaky"),
            conv3x3_fused_plain(x, wk, scale, shift, "leaky"))
    for name, (cin, cout) in NARROW_CONV_CASES.items():
        x = randn((1, 1280, 1280, cin))
        wk = randn((3, 3, cin, cout)) / (3 * cin ** 0.5)
        scale, shift = fold_affine(cout, randn((cout,)) * 0.1)
        out[name] = _err(
            conv3x3_fused(x.to(bf16), wk.to(bf16), scale, shift, "leaky"),
            conv3x3_fused_plain(x, wk, scale, shift, "leaky"))

    cin = 64
    x = randn((1, 320, 640, cin))
    wk = randn((3, 3, cin, cin // 2)) / 16
    scale, shift = fold_affine(cin // 2, randn((cin // 2,)) * 0.1)
    out["packed_deconv_64to32_640"] = _err(
        deconv2x_fused(x.to(bf16), wk.to(bf16), scale, shift, "relu"),
        deconv2x_fused_plain(x, wk, scale, shift, "relu"))

    x = randn((1, 640, 1280, 32)).to(bf16)
    out["packed_maxpool_1280"] = _err(pool2x(x, "max"),
                                      pool2x_plain(x.float(), "max"))

    # the fused head tail: 64-channel features whose channels >= K are zero,
    # error over the reference's max
    x = randn((1, 640, 640, 64))
    x[..., K:] = 0.0
    w3 = randn((3, 3, K, K)) * 0.05
    b3 = randn((K,)) * 0.1
    want = head_tail_plain(x, w3, b3).float()
    out["head_tail_fused_640_k51"] = _err(
        head_tail(x.to(bf16), w3.to(bf16), b3), want) / (
            float(want.abs().max()) + 1e-6)
    return out


@torch.inference_mode()
def _warp_case(device, seed):
    from sstem_tpu_torch.kernels import serving_warp
    from sstem_tpu_torch.ops import fold_flows, spatial_transform

    im = torch.rand((4, 1280, 1280, 1), generator=generator(device, seed),
                    device=device)
    flow = torch.from_numpy(fold_flows(4, 1280, 1280, seed)).to(device)
    return {"serving_warp_1280": _err(serving_warp(im, flow),
                                      spatial_transform(im, flow))}


def run_checks(device="cuda", seed=42):
    """Every case of ``CASES`` on the card, under the ``highest`` matmul
    precision and float32 activations (the caller's policy is set back
    after). Returns {case: {"max_abs_err", "tol", "ok"}, "all_ok": bool}.
    The CPU is refused: there the wrappers run their plain versions, so a
    case would hold the plain version against itself."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"gpu_checks holds the CUDA kernels against their "
                         f"plain versions; device {device!r} is not the card")
    gen = generator(device, seed)

    def randn(shape):
        return torch.randn(shape, generator=gen, device=device)

    with policy("highest"):
        errs = {**_sepconv_cases(randn), **_ifnet_case(device, seed),
                **_packed_cases(randn), **_warp_case(device, seed)}
    torch.cuda.synchronize(device)
    results = {name: {"max_abs_err": errs[name], "tol": tol,
                      "ok": bool(errs[name] <= tol)}
               for name, tol in CASES.items()}
    results["all_ok"] = all(v["ok"] for v in results.values())
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "GPU_CHECKS.json"))
    args = ap.parse_args(argv)
    if card_missing("gpu_checks"):
        return 2
    try:
        results = run_checks()
    except Exception as e:  # the tool's boundary: one error line, exit 2
        traceback.print_exc()
        print(json.dumps({"gpu_checks": "error",
                          "detail": f"{type(e).__name__}: {e}"}))
        return 2
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({"gpu_checks": "pass" if results["all_ok"] else "FAIL",
                      "n": len(results) - 1}))
    return 0 if results["all_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
