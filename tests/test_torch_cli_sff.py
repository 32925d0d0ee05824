"""The port's SFF inference CLIs (sstem_tpu_torch/cli/infer_interp.py,
infer_fusion.py, infer_unfolding.py, infer_interp_single.py,
infer_interp_trainingset.py, _ckpt.py, ops/flow_display.py, metrics.py) vs
the JAX package's, on the same reference-format checkpoints (the seeded
numpy weights of tests/_torch_port.py, K=5) and the same 64^2 PNG sections.

The CLIs run float32 on the CPU (the JAX pipeline's modules; the port's
cuDNN path with ``--device cpu``). Bounds:
  * every PNG the CLIs write (interp, fused, stitch, unfolded and the flow
    renderings, the single pair's and the training set's interp images)
    within 1 uint8 level: floor quantization of float32 results that
    differ in rounding;
  * scores.txt: the same lines in the same format, each PSNR within 0.1 dB
    and each SSIM within 2e-3 of the JAX CLI's (the scored PNGs differ by
    at most a level), each EPE within 1e-4 relative (float32 flows);
  * ``compute_ssim`` and ``dense_flow``: equal to JAX's on the same arrays.
"""

import re

import numpy as np
import pytest
import torch
from PIL import Image

from sstem_tpu import metrics as jax_metrics
from sstem_tpu.cli import infer_fusion as jax_fusion
from sstem_tpu.cli import infer_interp as jax_interp
from sstem_tpu.cli import infer_interp_single as jax_single
from sstem_tpu.cli import infer_interp_trainingset as jax_trainingset
from sstem_tpu.cli import infer_unfolding as jax_unfolding
from sstem_tpu.data.synthetic import synth_stack
from sstem_tpu.infer.pipeline import SFFPipeline as JaxSFFPipeline
from sstem_tpu.ops.flow_display import dense_flow as jax_dense_flow
from sstem_tpu_torch import metrics
from sstem_tpu_torch.cli import (
    infer_fusion, infer_interp, infer_interp_single, infer_interp_trainingset,
    infer_unfolding,
)
from sstem_tpu_torch.data.synthetic import write_triplet_tree
from sstem_tpu_torch.ops.flow import fold_flows
from sstem_tpu_torch.ops.flow_display import dense_flow

from _torch_port import port_sff_models, sff_variables

torch.set_num_threads(1)

K = 5
IDS = (1, 3, 5)
NAME = "sff"
CFG = f"TRAIN:\n  kernel_size: {K}\n  ngf: 32\nTEST:\n  pad: 0\n"
# the folders each CLI writes under its output path, by CLI
FOLDERS = {"interp": ("sff_interp",),
           "fusion": ("sff_fusion", "sff_fusion_stitching", "sff_fusion_flow"),
           "unfolding": ("sff_unfolding_fusionnet",
                         "sff_unfolding_fusionnet_flow")}


def _save(model, path):
    """A port module as a reference checkpoint: a ``model_weights``
    payload with ``nn.DataParallel``'s ``module.`` prefixes."""
    torch.save({"model_weights": {f"module.{k}": v for k, v in
                                  model.state_dict().items()}}, path)


def _args(root, out):
    """Both CLIs' shared arguments, writing under ``out``."""
    return ["-c", str(root / "cfg.yaml"), "-ip", str(root / "data"),
            "-t", NAME, "-op", str(root / out), "-m", "valid"]


def _fusion_args(root):
    """The fusion CLI's checkpoints and the JAX interp CLI's PNGs as its
    interp input, so that both fusion CLIs see the same inputs."""
    return ["--ckpt", str(root / "fusion.pth"), "--flow-ckpt",
            str(root / "flow.pth"),
            "--interp-dir", str(root / "jax" / "sff_interp")]


def _unfolding_args(root, out):
    """infer_unfolding's arguments: the stack's sections as the degraded
    inputs, the JAX interp CLI's PNGs as the interp inputs."""
    return _args(root, out) + ["--ckpt", str(root / "flow.pth"),
                               "--interp-dir", str(root / "jax" / "sff_interp")]


def _single_args(root, out):
    data = root / "data" / NAME
    return ["-c", str(root / "cfg.yaml"), "-i1", str(data / "0000.png"),
            "-i2", str(data / "0002.png"), "-o", str(root / f"{out}.png"),
            "--ckpt", str(root / "interp.pth")]


def _tree_config(root, who):
    """A triplet tree of 3 x 64^2 for ``who``'s infer_interp_trainingset
    (each CLI writes its images into the tree) and its config."""
    tree = root / f"tree_{who}"
    write_triplet_tree(str(tree), n_triplets=3, size=64, seed=72)
    path = root / f"cfg_{who}.yaml"
    path.write_text(CFG + f"DATA:\n  folder_name: {tree}\n"
                    "  train_txt: train_data.txt\n")
    return tree, ["-c", str(path), "--ckpt", str(root / "interp.pth")]


def _one_interp_pipeline():
    """A stand-in for ``SFFPipeline`` in the three JAX interp CLIs: the
    first call builds the pipeline, later calls with the same settings get
    that instance with their variables set. Its jitted functions take the
    variables as arguments, so every call runs the same program on the same
    inputs as with a pipeline of its own, and the interp is traced once
    instead of once per CLI."""
    built = {}

    def build(interp_vars, **settings):
        key = tuple(sorted(settings.items()))
        if key not in built:
            built[key] = JaxSFFPipeline(interp_vars=interp_vars, **settings)
        built[key].interp_vars = interp_vars
        return built[key]

    return build


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """A 7-section 64^2 stack as PNGs with 3 damaged ids (each with a
    ground-truth flow2 HDF5 sidecar and a ground-truth PNG for the
    unfolding CLI's valid mode), the port models as reference checkpoints,
    a config, a triplet tree, and the JAX CLIs' outputs, each made once.
    The JAX interp CLIs run one pair a call (-bs 1) on one pipeline
    (``_one_interp_pipeline``), which reuses one compiled interp."""
    import h5py

    root = tmp_path_factory.mktemp("sff_cli")
    data = root / "data" / NAME
    data.mkdir(parents=True)
    stack = synth_stack(7, 64, 64, seed=7)
    for i, img in enumerate(stack):
        Image.fromarray(img).save(data / f"{i:04d}.png")
    for i, flow in zip(IDS, fold_flows(len(IDS), 64, 64, seed=73)):
        with h5py.File(data / f"{i:04d}_flow.hdf", "w") as f:
            f.create_dataset("flow2", data=flow)
        Image.fromarray(stack[i + 1]).save(data / f"{i:04d}_gt.png")
    (root / "data" / f"{NAME}.txt").write_text(" ".join(map(str, IDS)))
    (root / "cfg.yaml").write_text(CFG)
    models = port_sff_models(K, sff_variables(K, seed=70))
    for name, model in zip(("interp", "flow", "fusion"), models):
        _save(model, root / f"{name}.pth")
    with pytest.MonkeyPatch.context() as mp:
        build = _one_interp_pipeline()
        for cli in (jax_interp, jax_single, jax_trainingset):
            mp.setattr(cli, "SFFPipeline", build)
        jax_interp.main(_args(root, "jax") +
                        ["--ckpt", str(root / "interp.pth")])
        jax_fusion.main(_args(root, "jax") + _fusion_args(root))
        jax_unfolding.main(_unfolding_args(root, "jax"))
        jax_single.main(_single_args(root, "jax_single"))
        jax_trainingset.main(_tree_config(root, "jax")[1] + ["-bs", "1"])
    return root


def _pngs(folder):
    return {p.name: np.asarray(Image.open(p)).astype(np.int32)
            for p in sorted(folder.glob("*.png"))}


def _scores(path):
    """scores.txt as [(label, psnr, ssim, epe or None)], and its lines with
    the numbers blanked (the format)."""
    lines = path.read_text().splitlines()
    rows = []
    for line in lines:
        m = re.fullmatch(r"(image=\d+|mean)(?:, |_)(?:(?:mean_)?EPE=(\S+), "
                         r"(?:mean_)?)?PSNR=(\S+), (?:mean_)?SSIM=(\S+)", line)
        epe = None if m.group(2) is None else float(m.group(2))
        rows.append((m.group(1), float(m.group(3)), float(m.group(4)), epe))
    return rows, [re.sub(r"-?\d+\.\d{4}", "#", line) for line in lines]


def _assert_pngs_within_a_level(want, got):
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        d = np.abs(got[name] - want[name]).max()
        assert d <= 1, (name, d)


@pytest.mark.parametrize("cli", ["interp", "fusion", "unfolding"])
def test_port_cli_matches_jax(case, cli):
    """The port's CLI on the CPU writes the JAX CLI's PNGs within 1 level
    and its scores.txt within 0.1 dB PSNR, 2e-3 SSIM and 1e-4 relative
    EPE, line for line."""
    out = f"port_{cli}"
    if cli == "interp":
        infer_interp.main(_args(case, out) + [
            "--ckpt", str(case / "interp.pth"), "--device", "cpu"])
    elif cli == "fusion":
        infer_fusion.main(_args(case, out) + _fusion_args(case)
                          + ["--device", "cpu"])
    else:
        infer_unfolding.main(_unfolding_args(case, out) + ["--device", "cpu"])
    for folder in FOLDERS[cli]:
        want, got = _pngs(case / "jax" / folder), _pngs(case / out / folder)
        assert sorted(want) == [f"{i:04d}.png" for i in IDS]
        _assert_pngs_within_a_level(want, got)
    want, want_shape = _scores(case / "jax" / FOLDERS[cli][0] / "scores.txt")
    got, got_shape = _scores(case / out / FOLDERS[cli][0] / "scores.txt")
    assert got_shape == want_shape and len(got) == len(IDS) + 1
    for (label, psnr, ssim, epe), (w_label, w_psnr, w_ssim, w_epe) in zip(
            got, want):
        assert label == w_label
        assert abs(psnr - w_psnr) <= 0.1 and abs(ssim - w_ssim) <= 2e-3, (
            label, psnr, w_psnr, ssim, w_ssim)
        assert (epe is None) == (w_epe is None) == (cli != "unfolding")
        if epe is not None:
            assert abs(epe - w_epe) <= 1e-4 * abs(w_epe), (label, epe, w_epe)


def test_port_interp_single_and_trainingset_match_jax(case):
    """infer_interp_single's PNG, and infer_interp_trainingset's images (the
    port at -bs 2, so its last call holds one row) and list, equal the JAX
    CLIs' within 1 level; the list exactly."""
    infer_interp_single.main(_single_args(case, "port_single")
                             + ["--device", "cpu"])
    _assert_pngs_within_a_level(_pngs_of(case, "jax_single.png"),
                                _pngs_of(case, "port_single.png"))
    tree, argv = _tree_config(case, "port")
    infer_interp_trainingset.main(argv + ["-bs", "2", "--device", "cpu"])
    want_tree = case / "tree_jax"
    assert ((tree / "interp_train_data.txt").read_text()
            == (want_tree / "interp_train_data.txt").read_text())
    want = _pngs(want_tree / "interp_train_data")
    assert sorted(want) == [f"{i:04d}.png" for i in range(3)]
    _assert_pngs_within_a_level(want, _pngs(tree / "interp_train_data"))


def _pngs_of(root, name):
    return {"one": np.asarray(Image.open(root / name)).astype(np.int32)}


def test_ssim_and_flow_rendering_match_jax():
    """``compute_ssim`` (uint8 and 0..1 inputs) and ``dense_flow`` (with a
    NaN and an unknown > 1e7 flow pixel) equal the JAX package's."""
    rng = np.random.default_rng(71)
    a = rng.integers(0, 256, (40, 52), dtype=np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-20, 21, a.shape), 0,
                255).astype(np.uint8)
    assert metrics.compute_ssim(a, b) == jax_metrics.compute_ssim(a, b)
    assert metrics.compute_ssim(a / 255.0, b / 255.0) == (
        jax_metrics.compute_ssim(a / 255.0, b / 255.0))
    flow = rng.normal(0, 3, (24, 31, 2)).astype(np.float32)
    flow[0, 0] = np.nan
    flow[1, 1] = 2e7
    np.testing.assert_array_equal(dense_flow(flow), jax_dense_flow(flow))
