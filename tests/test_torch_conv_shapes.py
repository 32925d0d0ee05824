"""Kernel coverage of the port's packed serving paths, on the CPU.

The SFF packed section (head tails on cuDNN and fused) and the SP packed
restore run at full channel widths on tiny inputs, with zeroed weights
(only the shapes matter). Every conv3x3_fused and deconv2x_fused call is
recorded by chip_smoke.py's KernelSignatures and must appear in its
kernel-vs-plain check lists, which phases 12 and 16 run on the card, and
have a kernel design; so must every head-tail and sepconv call, scaled to
the full-width run, in HEAD_TAIL_CHECKS and SEPCONV_CHECKS (phases 3 and
12). The interp trainer's sepconv backwards, recorded from one backward of
IFNet(51), must be in SEPCONV_BWD_CHECKS (phases 8, 10 and 11); the
fusion trainer's step and the unfolding and interp CLIs, scaled likewise,
must warp at WARP_CHECKS shapes and run sepconvs at SEPCONV_CHECKS
signatures (phases 4, 3, 21 and 22). A path that starts calling a new
signature fails here before it reaches the card. No JAX.
"""

import importlib
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from sstem_tpu_torch import config
from sstem_tpu_torch.infer.pipeline import SFFPipeline, SPPipeline
from sstem_tpu_torch.kernels import conv3x3, deconv, sepconv
from sstem_tpu_torch.models import FusionNet, FusionNetSP, IFNet, UNetSFF, UNetSP
from sstem_tpu_torch.models.layers import skip_init

ROOT = pathlib.Path(__file__).resolve().parent.parent
DESIGNS = {"conv3x3": conv3x3, "deconv2x": deconv}


def _zeroed(model):
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
        for name, b in model.named_buffers():
            b.fill_(1.0 if name.endswith("running_var") else 0.0)
    return model


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def sff_calls(smoke):
    """KernelSignatures of one packed section (a group of 2) per head-tail
    choice."""
    with skip_init():
        models = (_zeroed(IFNet(smoke.K)), _zeroed(FusionNet(ngf=32)),
                  _zeroed(UNetSFF()))
    calls = {}
    for fused in (False, True):
        pipe = SFFPipeline(*models, device="cpu", dtype=config.SERVING_DTYPE,
                           packed_conv=True, fused_head_tail=fused)
        with smoke.KernelSignatures() as sig:
            pipe.section(torch.zeros(2, 3, 64, 64))
        calls[fused] = sig
    return calls


@pytest.fixture(scope="module")
def sp_calls(smoke):
    """KernelSignatures of one packed SP restore (one quartet)."""
    with skip_init():
        nets = (_zeroed(IFNet(smoke.K, n_frames=2)), _zeroed(UNetSP()),
                _zeroed(FusionNetSP()))
    pipe = SPPipeline(*nets, device="cpu", dtype=config.SERVING_DTYPE,
                      packed_conv=True)
    img = np.zeros((1, 64, 64), np.uint8)
    with smoke.KernelSignatures() as sig:
        pipe.restore(img, img, img, img, img, img)
    return sig


@pytest.fixture(scope="module")
def sp_served_calls(smoke):
    """KernelSignatures of one served SP restore (one quartet: chip_smoke.py's
    ServedSP, the two-frame IFNet on ifnet_serve) per head-tail choice."""
    with skip_init():
        nets = (_zeroed(IFNet(smoke.K, n_frames=2)), _zeroed(UNetSP()),
                _zeroed(FusionNetSP()))
    img = np.zeros((1, 64, 64), np.uint8)
    calls = {}
    for path in ("served", "served_fused_tail"):
        served = smoke.build_sp_path(path, "cpu")
        served.vfi, served.denoise, served.fusion = nets
        with smoke.KernelSignatures() as sig:
            served.restore(img, img, img, img, img, img)
        calls[path] = sig
    return calls


# the tiny runs' inputs are 64^2; the paths run 1280^2 (SFF: 4 sections a
# group, SP: batch 2)
SCALE = 1280 // 64


def full_width_shapes(sig, n):
    """{(kernel, n, h, w, cin, cout, residual)} of the recorded calls, scaled
    to the full-width run."""
    return {(k[0], n, k[2] * SCALE, k[3] * SCALE, k[4], k[5], k[7])
            for k in sig.calls}


def full_width_maps(sig, n):
    """The recorded head-tail and sepconv signatures, scaled to the
    full-width run as the check lists write them."""
    out = set()
    for k in sig.maps:
        if k[0] == "head_tail":  # (n, hi, wi, cx, k)
            out.add((k[0], n, k[2] * SCALE, k[3] * SCALE, *k[4:]))
        else:  # (n, c, h, w, k, image dtype, maps dtype)
            out.add((k[0], n, k[2], k[3] * SCALE, k[4] * SCALE, *k[5:]))
    return out


def map_launches(sig, kernel):
    return sum(n for k, n in sig.maps.items() if k[0] == kernel)


def timed_shapes(smoke, checks, kernel="conv3x3"):
    return {(kernel, *row) for row in smoke.timing_rows(checks)}


@pytest.mark.parametrize("fused", [False, True], ids=["cudnn_tail", "fused_tail"])
def test_sff_packed_signatures_are_checked_on_the_card(smoke, sff_calls, fused):
    sig = sff_calls[fused]
    checked = (smoke.check_channels(smoke.SFF_CONV_CHECKS)
               | smoke.check_channels(smoke.DECONV_CHECKS, "deconv2x"))
    missing = sig.channels() - checked
    assert not missing, f"not in chip_smoke.py's check lists: {missing}"
    timed = (timed_shapes(smoke, smoke.SFF_CONV_CHECKS)
             | timed_shapes(smoke, smoke.DECONV_CHECKS, "deconv2x"))
    untimed = full_width_shapes(sig, 4) - timed
    assert not untimed, f"shapes phase 15 does not time: {untimed}"
    # and the launches per group that phase 14 asserts
    want = smoke.PATH_LAUNCHES["packed_fused_tail" if fused else "packed"]
    for kernel, name in (("conv3x3", "conv3x3_fused"),
                         ("deconv2x", "deconv2x_fused")):
        got = sum(n for k, n in sig.calls.items() if k[0] == kernel)
        assert got == want[name], (kernel, got, want[name])


def test_sp_packed_signatures_are_checked_on_the_card(smoke, sp_calls):
    missing = sp_calls.channels() - smoke.check_channels(smoke.SP_CONV_CHECKS)
    assert not missing, f"not in chip_smoke.py's check lists: {missing}"
    untimed = (full_width_shapes(sp_calls, smoke.SP_BATCH)
               - timed_shapes(smoke, smoke.SP_CONV_CHECKS))
    assert not untimed, f"shapes phase 18b does not time: {untimed}"
    # one restore call: phase 18's conv3x3 launches per batch
    got = sum(sp_calls.calls.values())
    assert got == smoke.SP_LAUNCHES["packed"]["conv3x3_fused"]


@pytest.mark.parametrize("path", ["served", "served_fused_tail"])
def test_sp_served_signatures_are_checked_on_the_card(smoke, sp_served_calls,
                                                      path):
    """The served SP path's conv3x3 signatures (the two-frame IFNet's and the
    U-Nets') are in SP_CONV_CHECKS and timed in phase 18b, its head-tail and
    sepconv signatures in the map check lists, and its launches per batch
    are phase 18's."""
    sig = sp_served_calls[path]
    missing = sig.channels() - smoke.check_channels(smoke.SP_CONV_CHECKS)
    assert not missing, f"not in chip_smoke.py's check lists: {missing}"
    untimed = (full_width_shapes(sig, smoke.SP_BATCH)
               - timed_shapes(smoke, smoke.SP_CONV_CHECKS))
    assert not untimed, f"shapes phase 18b does not time: {untimed}"
    unchecked = full_width_maps(sig, smoke.SP_BATCH) - smoke.MAP_CHECKS
    assert not unchecked, f"not in chip_smoke.py's check lists: {unchecked}"
    want = smoke.SP_LAUNCHES[path]
    assert sum(sig.calls.values()) == want["conv3x3_fused"]
    assert map_launches(sig, "sepconv") == want["sepconv_fwd"]
    assert map_launches(sig, "head_tail") == want.get("head_tail", 0)


@pytest.mark.parametrize("fused", [False, True], ids=["cudnn_tail", "fused_tail"])
def test_sff_packed_map_signatures_are_checked_on_the_card(smoke, sff_calls,
                                                           fused):
    sig = sff_calls[fused]
    assert {k[0] for k in sig.maps} == (
        {"sepconv", "head_tail"} if fused else {"sepconv"})
    unchecked = full_width_maps(sig, 4) - smoke.MAP_CHECKS
    assert not unchecked, f"not in chip_smoke.py's check lists: {unchecked}"
    assert not sig.map_channels() - {
        smoke.map_channel(k) for k in smoke.MAP_CHECKS}
    # and the launches per group that phase 14 asserts
    want = smoke.PATH_LAUNCHES["packed_fused_tail" if fused else "packed"]
    assert map_launches(sig, "sepconv") == want["sepconv_fwd"]
    assert map_launches(sig, "head_tail") == want.get("head_tail", 0)


def test_sp_packed_map_signatures_are_checked_on_the_card(smoke, sp_calls):
    unchecked = full_width_maps(sp_calls, smoke.SP_BATCH) - smoke.MAP_CHECKS
    assert not unchecked, f"not in chip_smoke.py's check lists: {unchecked}"
    assert {k[0] for k in sp_calls.maps} == {"sepconv"}
    assert (map_launches(sp_calls, "sepconv")
            == smoke.SP_LAUNCHES["packed"]["sepconv_fwd"])


def test_path_map_signatures_take_the_hopper_designs(sff_calls, sp_calls,
                                                     sp_served_calls):
    """At full width the paths' head tails and sepconvs run the new
    designs."""
    ht = importlib.import_module("sstem_tpu_torch.kernels.head_tail")
    for sig, n in ((sff_calls[True], 4), (sp_calls, 2),
                   (sp_served_calls["served_fused_tail"], 2)):
        for key in full_width_maps(sig, n):
            if key[0] == "head_tail":
                assert ht.design(key[3], key[4], key[5]) == "wgmma", key
            else:
                assert sepconv.design(key[4]) == "blocked", key


@pytest.mark.parametrize("kernel, shape, want", [
    ("head_tail", (640, 64, 51), "wgmma"), ("head_tail", (52, 56, 51), "wgmma"),
    ("head_tail", (40, 64, 56), "wgmma"), ("head_tail", (53, 64, 51), "mma"),
    ("head_tail", (52, 51, 51), "mma"), ("head_tail", (40, 64, 57), "mma"),
    ("sepconv", (1280,), "blocked"), ("sepconv", (180,), "blocked"),
    ("sepconv", (179,), "simple"), ("sepconv", (98,), "simple"),
    ("sepconv_bwd", (256,), "blocked"), ("sepconv_bwd", (52,), "blocked"),
    ("sepconv_bwd", (48,), "blocked"), ("sepconv_bwd", (4,), "blocked"),
    ("sepconv_bwd", (47,), "simple"), ("sepconv_bwd", (61,), "simple"),
    ("sepconv_bwd", (1,), "simple")])
def test_map_design_rule(kernel, shape, want):
    """The head tail's rule, and the rule both sepconv kernels share."""
    module = (importlib.import_module("sstem_tpu_torch.kernels.head_tail")
              if kernel == "head_tail" else sepconv)
    assert module.design(*shape) == want


def test_map_check_lists_hold_both_designs(smoke):
    """The head-tail and sepconv check lists reach each design of the entry
    point that picks by shape, and hold every path's dtypes."""
    ht = importlib.import_module("sstem_tpu_torch.kernels.head_tail")
    assert {ht.design(c[2], c[3], c[4]) for c in smoke.HEAD_TAIL_CHECKS} == set(
        ht.ENTRY_POINTS)
    assert {sepconv.design(c[3]) for c in smoke.SEPCONV_CHECKS} == set(
        sepconv.ENTRY_POINTS)
    assert {c[5:] for c in smoke.SEPCONV_CHECKS} == {
        (a, b) for a in ("float32", "bfloat16") for b in ("float32", "bfloat16")}
    assert {c[4] for c in smoke.SEPCONV_CHECKS} >= {5, 11, smoke.K}


@pytest.fixture(scope="module")
def train_calls(smoke):
    """KernelSignatures of one L1 backward of IFNet(51) (the interp
    trainer's model) on a 32^2 crop, batch 1."""
    from sstem_tpu_torch import losses

    with skip_init():
        model = _zeroed(IFNet(smoke.K))
    x = torch.zeros(1, 6, 32, 32)
    with smoke.KernelSignatures() as sig:
        losses.l1_loss(model(x), torch.ones(1, 1, 32, 32)).backward()
    return sig


# the trainer's step runs batch 32 of 256^2 crops
TRAIN_SCALE = 256 // 32


def test_training_backward_signatures_are_checked_on_the_card(smoke,
                                                              train_calls):
    """The training step's sepconv backwards, scaled to 32 x 256^2, are in
    SEPCONV_BWD_CHECKS (phases 8, 10 and 11) and take the blocked design;
    2 a step, as phase 10 asserts."""
    bwd = {k: n for k, n in train_calls.maps.items() if k[0] == "sepconv_bwd"}
    assert sum(bwd.values()) == 2
    full = {(smoke.TRAIN_BATCH * k[1], k[2], k[3] * TRAIN_SCALE,
             k[4] * TRAIN_SCALE, *k[5:]) for k in bwd}
    assert full == {smoke.SEPCONV_BWD_CHECKS[0]}
    for sig in full:
        assert ("sepconv_bwd", *sig) in smoke.MAP_CHECKS
        assert sepconv.design(sig[3]) == "blocked", sig


def test_sp_training_signatures_are_checked_on_the_card(smoke):
    """One L1 step of the two-frame IFNet(51) (the SP interp and fusion
    trainers' VFI branch) on a 32^2 crop, batch 1, scaled to the trainers'
    256^2: 4 sepconv forwards and 4 backwards (2 frames x 2), all at
    SP_TRAIN_SIG, which SEPCONV_CHECKS and SEPCONV_BWD_CHECKS hold (phases
    3 and 8; phase 23 asserts them) on the blocked designs."""
    from sstem_tpu_torch import losses

    with skip_init():
        model = _zeroed(IFNet(smoke.K, n_frames=2))
    with smoke.KernelSignatures() as sig:
        losses.l1_loss(model(torch.zeros(1, 6, 32, 32)),
                       torch.ones(1, 2, 32, 32)).backward()
    scale = smoke.SP_TRAIN_PATCH // 32
    for kernel in ("sepconv", "sepconv_bwd"):
        calls = {k: n for k, n in sig.maps.items() if k[0] == kernel}
        assert sum(calls.values()) == 4, calls
        full = {(k[1] * smoke.SP_TRAIN_BATCH, k[2], k[3] * scale,
                 k[4] * scale, *k[5:]) for k in calls}
        assert full == {smoke.SP_TRAIN_SIG}, full
        assert (kernel, *smoke.SP_TRAIN_SIG) in smoke.MAP_CHECKS
    assert smoke.SP_TRAIN_SIG in smoke.SEPCONV_CHECKS
    assert smoke.SP_TRAIN_SIG in smoke.SEPCONV_BWD_CHECKS[1:]  # phase 8's rows
    assert sepconv.design(smoke.SP_TRAIN_SIG[3]) == "blocked"


@pytest.mark.parametrize("n_frames", [1, 2])
def test_bf16_policy_training_signatures_are_checked_on_the_card(smoke,
                                                                 n_frames):
    """Under the bf16 compute dtype (``config.set_compute_dtype``, phase
    28) one L1 step of IFNet(51) (the interp trainer's, and the two-frame
    net of the SP interp and fusion trainers) on a 32^2 crop, scaled to
    the trainers' batches and crops, runs its sepconvs forward and backward
    at BF16_TRAIN_SIG and BF16_SP_TRAIN_SIG: bf16 frames and tap maps,
    held in SEPCONV_CHECKS and SEPCONV_BWD_CHECKS (phases 3 and 8) on the
    blocked designs."""
    from sstem_tpu_torch import losses

    with skip_init():
        model = _zeroed(IFNet(smoke.K, n_frames=n_frames))
    prior = config.compute_dtype()
    config.set_compute_dtype("bfloat16")
    try:
        with smoke.KernelSignatures() as sig:
            losses.l1_loss(model(torch.zeros(1, 6, 32, 32)),
                           torch.ones(1, n_frames, 32, 32)).backward()
    finally:
        config.COMPUTE_DTYPE = prior
    batch, patch, want = ((smoke.TRAIN_BATCH, smoke.TRAIN_PATCH,
                           smoke.BF16_TRAIN_SIG) if n_frames == 1 else
                          (smoke.SP_TRAIN_BATCH, smoke.SP_TRAIN_PATCH,
                           smoke.BF16_SP_TRAIN_SIG))
    for kernel in ("sepconv", "sepconv_bwd"):
        calls = {k: n for k, n in sig.maps.items() if k[0] == kernel}
        assert sum(calls.values()) == 2 * n_frames, calls
        full = {(k[1] * batch, k[2], k[3] * patch // 32, k[4] * patch // 32,
                 *k[5:]) for k in calls}
        assert full == {want}, full
        assert (kernel, *want) in smoke.MAP_CHECKS
    assert want[5:] == ("bfloat16", "bfloat16")
    assert sepconv.design(want[3]) == "blocked"


def test_recorded_backward_launch_is_counted_once(smoke, monkeypatch):
    """A backward launch on the card, recorded by KernelSignatures, still
    counts once in sepconv_planar_bwd.launches (phase 10 asserts 2 a step):
    the recorder wraps the launch, not the counted wrapper. The launch
    itself is replaced here; the tensors only claim the card."""
    import types

    def on_card(shape):
        return types.SimpleNamespace(shape=shape, dtype=torch.float32,
                                     device=torch.device("cuda"))

    image, maps = on_card((1, 1, 60, 60)), on_card((1, smoke.K, 10, 10))
    monkeypatch.setattr(sepconv, "launch_bwd_entry", lambda *args: args[1:3])
    monkeypatch.setattr(sepconv.sepconv_planar_bwd, "launches", 0)
    with smoke.KernelSignatures() as sig:
        sepconv._sepconv_bwd(image, maps, maps, on_card((1, 1, 10, 10)))
    assert sepconv.sepconv_planar_bwd.launches == 1
    assert dict(sig.maps) == {("sepconv_bwd", 1, 1, 10, 10, smoke.K,
                               "float32", "float32"): 1}


def test_sepconv_bwd_check_list_holds_both_designs(smoke):
    """SEPCONV_BWD_CHECKS reaches both backward designs, bf16 maps, more
    channels than one block of the blocked design stages, and C > 1 at an
    odd height on the blocked design."""
    rows = smoke.SEPCONV_BWD_CHECKS
    assert {sepconv.design(c[3]) for c in rows} == set(
        sepconv.BWD_ENTRY_POINTS)
    assert any(c[6] == "bfloat16" for c in rows)
    assert max(c[1] for c in rows) > 4
    assert any(c[1] > 1 and c[2] % 2 and sepconv.design(c[3]) == "blocked"
               for c in rows)
    assert {c[4] for c in rows} >= {5, 11, smoke.K}


def test_every_path_signature_has_a_design(sff_calls, sp_calls,
                                           sp_served_calls):
    for sig in (*sff_calls.values(), sp_calls, *sp_served_calls.values()):
        for kernel, cin, cout, _, _ in sig.channels():
            module = DESIGNS[kernel]
            assert module.design(cin, cout) in module.ENTRY_POINTS


@pytest.mark.parametrize("kernel, cin, cout, want", [
    ("conv3x3", 32, 32, "wgmma"), ("conv3x3", 64, 51, "wgmma"),
    ("conv3x3", 128, 128, "wgmma"), ("conv3x3", 2, 32, "mma"),
    ("conv3x3", 6, 6, "mma"), ("conv3x3", 64, 1, "mma"),
    ("conv3x3", 51, 51, "mma"), ("deconv2x", 128, 64, "wgmma"),
    ("deconv2x", 64, 32, "wgmma"), ("deconv2x", 51, 27, "mma")])
def test_design_rule(kernel, cin, cout, want):
    assert DESIGNS[kernel].design(cin, cout) == want


def test_check_lists_run_at_full_width(smoke):
    """The path checks run at the full-width shapes: the SFF canvas 1280^2
    and its halves, 4 sections a group; the SP 1280^2, batch 2. Each
    check's shape is also a timed row of phases 15 and 18b."""
    for checks, n, sizes in ((smoke.SFF_CONV_CHECKS, 4, (1280, 640)),
                             (smoke.DECONV_CHECKS, 4, (640, 320)),
                             (smoke.SP_CONV_CHECKS, smoke.SP_BATCH, (1280, 640))):
        rows = smoke.timing_rows(checks)
        for c in checks:
            assert c[0] == n and c[1] == c[2] and c[1] in sizes, c
            assert (*c[:5], c[6]) in rows


# ---------------------------------------------------------------------------
# the SFF correction and fusion slice: the fusion trainer's step and the
# unfolding and interp CLIs (phases 21 and 22)
# ---------------------------------------------------------------------------

def test_fusion_step_warp_is_checked_on_the_card(smoke):
    """One fusion step on each datagen path (batch SFF_TRAIN_BATCH of 50^2
    crops to 32^2, zeroed FusionNet ngf 32, ``build``'s UNetSFF) warps once,
    at a shape that, scaled to the card's 256^2 crops, is in WARP_CHECKS
    (phase 4 checks it, phase 21 asserts 1 a step)."""
    from sstem_tpu_torch.cli import train_fusion
    from sstem_tpu_torch.compat.config import AttrDict
    from sstem_tpu_torch.train.trainer import TrainState, make_train_step

    n, det = smoke.SFF_TRAIN_BATCH, 32
    with skip_init():
        flow_net = _zeroed(FusionNet(ngf=32)).eval().requires_grad_(False)
    cfg = AttrDict({"TRAIN": {"output_nc": 1, "base_lr": 1e-4, "end_lr": 1e-4,
                              "weight_decay": 1e-4}})
    unet, opt, host_step, _, _ = train_fusion.build(cfg, flow_net, "cpu")
    device_step = make_train_step(train_fusion.make_fusion_devgen_loss(
        flow_net, det_size=det))
    clean = torch.zeros(n, 50, 50, dtype=torch.uint8)
    for step, batch in ((host_step, (torch.zeros(n, 6, det, det),
                                     torch.zeros(n, 1, det, det))),
                        (device_step, (clean, clean, 1))):
        with smoke.KernelSignatures() as sig:
            step(TrainState(unet, opt), batch)
        scale = smoke.SFF_TRAIN_DET // det
        assert {(k[0], k[1] * scale, k[2] * scale): v
                for k, v in sig.warps.items()} == {
            (n, smoke.SFF_TRAIN_DET, smoke.SFF_TRAIN_DET): 1}
        assert (n, smoke.SFF_TRAIN_DET, smoke.SFF_TRAIN_DET) in smoke.WARP_CHECKS


def _reference_ckpt(model, path):
    torch.save({"model_weights": model.state_dict()}, path)
    return str(path)


def test_new_cli_signatures_are_checked_on_the_card(smoke, tmp_path):
    """infer_unfolding on a 50^2 section (the card's 1250^2: scale 25),
    infer_interp_single on a 64^2 pair (the card's 1280^2 canvas: scale 20)
    and infer_interp_trainingset at -bs TRAININGSET_BS on 64^2 rows (the
    card's 512^2: scale 8), zeroed K=51 IFNet and ngf-32 FusionNet: warp 1
    a section and sepconv 2 a pair or batch, at signatures that scaled are
    in WARP_CHECKS and SEPCONV_CHECKS (phases 4 and 3 check them, phases 21
    and 22 assert them)."""
    from PIL import Image

    from sstem_tpu_torch.cli import (
        infer_interp_single, infer_interp_trainingset, infer_unfolding,
    )
    from sstem_tpu_torch.data.synthetic import write_triplet_tree

    with skip_init():
        ifnet = _reference_ckpt(_zeroed(IFNet(smoke.K)), tmp_path / "i.pth")
        flow = _reference_ckpt(_zeroed(FusionNet(ngf=32)), tmp_path / "f.pth")
    bs = smoke.TRAININGSET_BS
    tree = tmp_path / "tree"
    write_triplet_tree(str(tree), n_triplets=bs, size=64, seed=0)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"TRAIN:\n  kernel_size: {smoke.K}\n  ngf: 32\n"
                   f"DATA:\n  folder_name: {tree}\n  train_txt: train_data.txt\n")
    (tmp_path / "d" / "s").mkdir(parents=True)
    (tmp_path / "d" / "s.txt").write_text("1")
    (tmp_path / "interp").mkdir()
    img = Image.fromarray(np.zeros((50, 50), np.uint8))
    img.save(tmp_path / "d" / "s" / "0001.png")
    img.save(tmp_path / "interp" / "0001.png")
    runs = (
        (infer_unfolding.main,
         ["-c", str(cfg), "-ip", str(tmp_path / "d"), "-t", "s", "-op",
          str(tmp_path / "out"), "-m", "test", "--ckpt", flow,
          "--interp-dir", str(tmp_path / "interp")], 25),
        (infer_interp_single.main,
         ["-c", str(cfg), "-i1", str(tree / "0000_1.png"), "-i2",
          str(tree / "0000_3.png"), "-o", str(tmp_path / "one.png"),
          "--ckpt", ifnet], 1280 // 64),
        (infer_interp_trainingset.main,
         ["-c", str(cfg), "--ckpt", ifnet, "-bs", str(bs)],
         smoke.TRAININGSET_SIZE // 64))
    for main, argv, scale in runs:
        with smoke.KernelSignatures() as sig:
            main(argv + ["--device", "cpu"])
        warps = {(k[0], k[1] * scale, k[2] * scale): v
                 for k, v in sig.warps.items()}
        maps = {(k[0], k[1], k[2], k[3] * scale, k[4] * scale, *k[5:]): v
                for k, v in sig.maps.items()}
        if main is infer_unfolding.main:
            assert warps == {(1, 1250, 1250): 1} and not maps
        else:
            n = bs if main is infer_interp_trainingset.main else 1
            assert not warps and sum(maps.values()) == 2
        assert set(warps) <= set(smoke.WARP_CHECKS), warps
        assert set(maps) <= smoke.MAP_CHECKS, maps
        if maps:
            assert {k[1] for k in maps} == {n}
