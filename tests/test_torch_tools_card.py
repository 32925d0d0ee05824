"""The port's on-card tools (sstem_tpu_torch/tools/: gpu_checks, the six
profilers, verify_drive) and the batched head tail
(``ifnet_serve(batched_head_tail=True)``), on the CPU.

The tools measure and check the card; here they are held to what the CPU
can show: gpu_checks' cases are the JAX tool's (``TPU_CHECKS.json``) by
name and tolerance, each profiler's rows carry the JAX tool's labels at a
tiny size on ``device="cpu"``, the verify drive's fraction and stitch-flip
rules hold on small uint8 arrays, and every tool without a card prints one
``gpu_unavailable`` line and exits 2. The batched tail is held to the
per-head cuDNN tail at K=11, 64^2 (its JAX counterpart is held in
tests/test_torch_serving.py::test_ifnet_serve_two_frame_matches_jax_serve).
No JAX here.
"""

import importlib
import json
import os

import numpy as np
import pytest
import torch

from sstem_tpu_torch import config
from sstem_tpu_torch.infer.pipeline import SFFPipeline
from sstem_tpu_torch.models import IFNet
from sstem_tpu_torch.models.serving import ifnet_serve
from sstem_tpu_torch.tools import gpu_checks, verify_drive

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("gpu_checks", "profile_pipeline", "profile_serve", "profile_fine",
         "ifnet_prefix_bench", "micro_conv_bench", "bench_conv3x3",
         "verify_drive", "conv_variants")

# each JAX tool's row labels, restated from the tool, and the port
# function's call at a tiny size on the CPU (one call, no warm-up)
JAX_ROWS = {
    # tools/profile_pipeline.py:62, 66, 71, 76, 79
    "profile_pipeline": (
        ("sepconv (1ch, K=51)", "IFNet fwd", "FusionNet fwd", "UNetSFF fwd",
         "warp (1ch)"),
        dict(size=32, iters=1, warm=0)),
    # tools/profile_serve.py:67, 111, 137, 157, 164, 175, 180, 189, 191,
    # 195, 199; then the port's two tail rows
    "profile_serve": (
        ("ifnet_serve (full)", "  trunk (to featq)", "  1 head (full tail)",
         "    head conv0-2", "    planar upsample 2x",
         "    planar conv3 51->51", "  sepconv planar 1ch",
         "fusionnet_serve (2ch)", "unet_sff_serve (2ch)", "warp XLA (1ch)",
         "warp banded serving (1ch)", "    head tail kernel (fused tail)",
         "  4 head tails batched (grouped conv3)"),
        dict(size=32, batch=1, iters=1, warm=0)),
    # tools/profile_fine.py:67, 106, 118, 131, 136, 141, 144
    "profile_fine": (
        ("IFNet packed (full)", "IFNet trunk (to x64)",
         "1 kernel head (packed)", "sepconv planar (1ch)", "FusionNet (flow)",
         "UNetSFF (fusion)", "warp (1ch)"),
        dict(size=32, batch=1, iters=1, warm=0)),
    # tools/ifnet_prefix_bench.py:102
    "ifnet_prefix_bench": (
        ("L0", "enc", "dec", "heads", "full"),
        dict(size=32, iters=1, warm=0)),
    # tools/micro_conv_bench.py:50-130
    "micro_conv_bench": (
        ("conv3x3 32->32 @1280 bf16", "conv3x3 64->64 @640 bf16",
         "conv3x3 128->128 @320 bf16", "conv3x3 256->256 @160 bf16",
         "conv3x3 512->512 @80 bf16", "deconv(dilated) 64->32 @640->1280",
         "deconv(d2s 3x3-4phase) 64->32 @640->1280",
         "conv3x3 51->51 @1280 bf16 (head conv3)",
         "conv3x3 51->51 @1280 NCHW planar",
         "conv3x3 64->64 @1280 NHWC (padded)",
         "conv3x3 grouped4 204->204 @1280 NHWC",
         "conv3x3 grouped4 256->256 @1280 NHWC",
         "conv3x3 51->51 @1280 NCHW batchx4 (/4)",
         "conv3x3 64->64 @1280 NCHW planar (padded)", "conv3x3 6->32 @1280",
         "maxpool2x2 @1280x32", "BN-eval elementwise @1280x32 (unfused)"),
        dict(size=32, batch=1, iters=1, warm=0)),
    # tools/bench_conv3x3.py:39-40 (the cases), :82 (f"C{c:3d} @{hw}")
    "bench_conv3x3": (
        ("C 32 @1280", "C 64 @1280", "C 64 @640", "C128 @640"),
        dict(size=32, iters=1, warm=0)),
}


def _bf16_ulp(x):
    """One bf16 unit in the last place of |x| (8 significant bits)."""
    m = x.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


@pytest.fixture(scope="module")
def interp():
    """IFNet(11) on seeded weights (eval) and a 64^2 gray pair."""
    g = torch.Generator().manual_seed(5)
    model = IFNet(11, generator=g).eval()
    return model, torch.rand((1, 64, 64, 2), generator=g)


def test_batched_head_tail_matches_cudnn_tail(interp):
    """The four tails in one upsample and one grouped conv3 against the
    per-head cuDNN tails: each output within 1 bf16 ulp of the value, or
    2^-8 of the largest, where the grouped conv sums in another order."""
    model, x = interp
    with torch.inference_mode():
        want = ifnet_serve(model, x)
        got = ifnet_serve(model, x, batched_head_tail=True)
    bound = torch.maximum(_bf16_ulp(want), want.abs().max() * 2.0 ** -8)
    assert got.shape == want.shape == (1, 64, 64, 1)
    assert bool(((got - want).abs() <= bound).all()), float(
        (got - want).abs().max())


def test_fused_head_tail_wins_over_batched(interp):
    """With both switches set the fused tail runs, as the JAX forward picks
    its fused tail first (sstem_tpu/models/serving.py:526-531)."""
    model, x = interp
    with torch.inference_mode():
        fused = ifnet_serve(model, x, fused_head_tail=True)
        both = ifnet_serve(model, x, fused_head_tail=True,
                           batched_head_tail=True)
    assert torch.equal(both, fused)


def test_sff_pipeline_batched_head_tail(interp):
    """SFFPipeline(batched_head_tail=True) routes its interp through the
    batched tail (the packed path's interp equals ``ifnet_serve``'s), and
    needs packed_conv."""
    model, x = interp
    with pytest.raises(ValueError, match="need packed_conv=True"):
        SFFPipeline(model, None, None, "cpu", batched_head_tail=True)
    pipe = SFFPipeline(model, None, None, "cpu", dtype=config.SERVING_DTYPE,
                       packed_conv=True, batched_head_tail=True)
    prev, nxt = (torch.floor(x[..., i] * 255) for i in (0, 1))
    got = pipe.interpolate(prev, nxt, clip=False)
    with torch.inference_mode():
        want = ifnet_serve(model, torch.stack([prev, nxt], -1) / 255.0,
                           batched_head_tail=True)[..., 0]
    assert torch.equal(got, want)


def test_gpu_checks_cases_are_tpu_checks():
    """Every case of TPU_CHECKS.json is a gpu_checks case of the same name
    and tolerance, but the JAX packed IFNet twin's, whose place takes the
    serving forward against the module; the warp case and conv3x3's two
    narrow designs are added."""
    with open(os.path.join(ROOT, "TPU_CHECKS.json")) as f:
        tpu = {k: v["tol"] for k, v in json.load(f).items()
               if isinstance(v, dict)}
    del tpu["ifnet_packed_vs_reference_rel"]
    assert {k: gpu_checks.CASES.get(k) for k in tpu} == tpu
    assert set(gpu_checks.CASES) - set(tpu) == {
        "ifnet_serve_vs_module_nrmse", "serving_warp_1280",
        *gpu_checks.NARROW_CONV_CASES}
    with pytest.raises(ValueError, match="not the card"):
        gpu_checks.run_checks("cpu")


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_without_card_exits_2(tool, monkeypatch, capsys, tmp_path):
    """Without a card each tool prints one gpu_unavailable line and exits
    2 (tools/tpu_checks.py:174-199's tpu_unavailable); none runs on the
    CPU unasked, and gpu_checks writes no file."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"sstem_tpu_torch.tools.{tool}")
    argv = ["--out", str(tmp_path / "out.json")] if tool == "gpu_checks" else []
    assert module.main(argv) == 2
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == {
        tool: "error", "error": "gpu_unavailable",
        "detail": "torch.cuda.is_available() is False"}
    assert not (tmp_path / "out.json").exists()


@pytest.mark.parametrize("tool", list(JAX_ROWS))
def test_profiler_rows_are_the_jax_labels(tool):
    """Each profiler's function on the CPU at a tiny size returns one
    finite, positive time for each of the JAX tool's rows, by its label."""
    labels, kwargs = JAX_ROWS[tool]
    module = importlib.import_module(f"sstem_tpu_torch.tools.{tool}")
    rows = getattr(module, tool)(device="cpu", **kwargs)
    assert list(rows) == list(labels)
    for value in rows.values():
        times = ([value["kernel_ms"], value["library_ms"]]
                 if isinstance(value, dict) else [value])
        assert all(np.isfinite(t) and t > 0 for t in times), (tool, value)


def test_verify_drive_mismatch_frac():
    a = np.array([[0, 10, 20, 255]], np.uint8)
    b = np.array([[1, 12, 17, 253]], np.uint8)
    assert verify_drive.mismatch_frac(a, b) == 0.75
    assert verify_drive.mismatch_frac(a, b, levels=2) == 0.25
    assert verify_drive.mismatch_frac(a, a) == 0.0


def test_verify_drive_stitch_flip_rule():
    """A stitch pixel more than 1 level off counts unless a warped level
    moved by at most 2 across the stitch threshold of 2 (which swaps the
    interp for the warped level)."""
    got = {"warped": np.array([[1, 3, 3, 50, 0]], np.uint8),
           "stitch": np.array([[90, 3, 3, 50, 40]], np.uint8)}
    want = {"warped": np.array([[2, 0, 3, 50, 1]], np.uint8),
            "stitch": np.array([[2, 90, 9, 55, 40]], np.uint8)}
    # pixel 0: flip by 1 (explained); 1: flip by 3 (counted); 2, 3: no
    # flip (counted); 4: equal stitch
    assert verify_drive.stitch_unexplained_frac(got, want) == 0.6
    assert verify_drive.stitch_unexplained_frac(got, got) == 0.0
