"""The port's SP quartet restore (sstem_tpu_torch/models/{ifnet,unet_sp}.py,
compat/weights.py, infer/pipeline.py::SPPipeline, cli/test_sp_fusion.py)
vs the JAX package, on the same seeded numpy weights (tests/_torch_port.py)
and inputs.

Bounds:
  * models, float32 eval: 5e-4 abs (tests/test_torch_models.py's), the
    JAX side at HIGHEST matmul precision;
  * weights: JAX vars -> port state dict -> the JAX importer, exact;
  * pipeline, float32 against the JAX ``SPPipeline(packed_conv=False)``:
    every output within 1e-3 abs (float32 sums in another order);
  * pipeline, packed path in bf16 against the same JAX float32 results:
    NRMSE below 0.05 of each output's std, the bound tests/test_serving.py
    sets between the JAX package's own packed forwards and its modules;
  * CLI: the port's and the JAX ``test_sp_fusion`` PNGs within 1 level
    (floor quantization of float32 results that differ in rounding).
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import sstem_tpu.config as jax_cfg
from sstem_tpu.cli import test_sp_fusion as jax_cli
from sstem_tpu.compat.torch_ckpt import load_torch_ifnet, load_torch_unet_sp
from sstem_tpu.data.synthetic import synth_stack
from sstem_tpu.infer.pipeline import SPPipeline as JaxSPPipeline
from sstem_tpu.models import UNetSP as JaxUNetSP
from sstem_tpu_torch.cli import test_sp_fusion as port_cli
from sstem_tpu_torch.compat import load_reference
from sstem_tpu_torch.config import SERVING_DTYPE
from sstem_tpu_torch.infer.pipeline import SPPipeline
from sstem_tpu_torch.models import IFNet
from sstem_tpu_torch.models.layers import skip_init

from _torch_port import port_module, port_sp_models, sp_variables

torch.set_num_threads(1)

K = 5
TOL = 5e-4
OUTPUTS = ("pred1", "pred2", "vfi1", "vfi2", "denoise1", "denoise2")


def _quartet(seed=4, hw=64):
    """img1, img4, deg2, deg3, mask2, mask3 as (1, H, W) uint8: a synthetic
    quartet, one mask all 128 and one random 0/255."""
    s = synth_stack(4, hw, hw, seed=seed)
    rng = np.random.default_rng(seed)
    m2 = np.full((1, hw, hw), 128, np.uint8)
    m3 = ((rng.random((1, hw, hw)) > 0.8) * 255).astype(np.uint8)
    return s[0:1], s[3:4], s[1:2], s[2:3], m2, m3


def _write_case(folder, quartet, models):
    """The quartet as PNGs and the port models as reference-format
    checkpoints (``model_weights`` payloads with ``module.`` prefixes), and
    the CLI arguments (without -sp) that read them."""
    data = folder / "data"
    data.mkdir()
    names = ("1.png", "4.png", "2.png", "3.png", "2m.png", "3m.png")
    for name, img in zip(names, quartet):
        Image.fromarray(img[0]).save(data / name)
    args = ["-dp", str(data), "-im1", "1.png", "-im4", "4.png",
            "-im2d", "2.png", "-im3d", "3.png", "-im2m", "2m.png",
            "-im3m", "3m.png", "--kernel-size", str(K)]
    for name, model in zip(("vfi", "denoise", "fusion"), models):
        path = str(folder / f"{name}.pth")
        torch.save({"model_weights": {f"module.{k}": v for k, v in
                                      model.state_dict().items()}}, path)
        args += [f"--{name}", path]
    return args


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    """Weights, port models, inputs and JAX results, each computed once.

    The JAX CLI runs here, on the port models' checkpoints: its
    ``SPPipeline(packed_conv=False)`` is kept and gives the pipeline results
    and the IFNet output too, so that the JAX pipeline is traced and
    compiled once (seconds each time)."""
    variables = sp_variables(K, seed=40)
    models = port_sp_models(K, variables)
    iv, dv, fv = variables
    rng = np.random.default_rng(41)
    x6 = rng.random((1, 64, 64, 6), dtype=np.float32)
    u1 = rng.random((1, 32, 64, 1), dtype=np.float32)
    u2 = rng.random((1, 32, 64, 1), dtype=np.float32)
    odd = rng.random((1, 40, 56, 1), dtype=np.float32)
    quartet = _quartet()
    folder = tmp_path_factory.mktemp("sp_cli")
    cli_args = _write_case(folder, quartet, models)
    made = []

    class Recorded(JaxSPPipeline):
        def __post_init__(self):
            super().__post_init__()
            made.append(self)

    prev = jax_cfg.matmul_precision()
    jax_cfg.set_matmul_precision("highest")
    jax_cli.SPPipeline = Recorded
    try:
        jax_cli.main(cli_args + ["-sp", str(folder / "jax")])
        (jpipe,) = made
        assert not jpipe.packed_conv
        unet = jax.jit(lambda v, x: JaxUNetSP(1).apply(v, x, train=False))
        want = {
            # the pipeline's jitted IFNet(K, n_frames=2).apply at its own
            # input shape, on the same weights as loaded from the checkpoint
            "ifnet": np.asarray(jpipe._vfi_fn(iv, jnp.asarray(x6))),
            "unet_sp": np.asarray(unet(dv, jnp.asarray(u1))),
            "unet_sp_odd": np.asarray(unet(dv, jnp.asarray(odd))),
            # FusionNetSP.apply(v, a, b) is the backbone on a + b
            # (unet_sp.py:92-99): the compiled UNetSP apply serves it
            "fusionnet_sp": np.asarray(unet(fv, jnp.asarray(u1 + u2))),
        }
        out = jpipe.restore(*(jnp.asarray(a) for a in quartet))
        want["pipeline"] = {k: np.asarray(v) for k, v in out.items()}
    finally:
        jax_cli.SPPipeline = JaxSPPipeline
        jax_cfg.set_matmul_precision(prev.name.lower())
    return {"vars": variables, "models": models,
            "inputs": {"x6": x6, "u1": u1, "u2": u2, "odd": odd},
            "quartet": quartet, "want": want, "cli": (folder, cli_args)}


def _nchw(a):
    return torch.from_numpy(a.transpose(0, 3, 1, 2).copy())


@pytest.mark.parametrize("name", ["ifnet", "unet_sp", "unet_sp_odd",
                                  "fusionnet_sp"])
def test_sp_model_matches_flax(sp, name):
    """IFNet(n_frames=2) at K=5, 64^2; UNetSP at 32x64 and at 40x56 (odd
    sizes on the way down, so the Up blocks pad to match); FusionNetSP at
    32x64."""
    vfi, denoise, fusion = sp["models"]
    x = sp["inputs"]
    with torch.inference_mode():
        got = {"ifnet": lambda: vfi(_nchw(x["x6"])),
               "unet_sp": lambda: denoise(_nchw(x["u1"])),
               "unet_sp_odd": lambda: denoise(_nchw(x["odd"])),
               "fusionnet_sp": lambda: fusion(_nchw(x["u1"]), _nchw(x["u2"]))
               }[name]().numpy().transpose(0, 2, 3, 1)
    want = sp["want"][name]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def _assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), path
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and np.array_equal(x, y), f"{path}/{k}"


@pytest.mark.parametrize("index", [0, 1, 2])
def test_sp_vars_round_trip_through_port_state_dict(sp, index):
    """JAX vars -> port state dict -> strict load -> state_dict() -> the JAX
    package's importers (``load_torch_ifnet(n_frames=2)``,
    ``load_torch_unet_sp``) give the JAX vars back."""
    importer = [lambda sd: load_torch_ifnet(sd, n_frames=2),
                load_torch_unet_sp, load_torch_unet_sp][index]
    back = importer(sp["models"][index].state_dict())
    _assert_trees_equal(back, sp["vars"][index])


def test_two_frame_heads_follow_the_reference_order(sp):
    """Frame f's k1h, k1v, k2h, k2v are ``upconv51_{f}1..4``: the 1-frame
    net's order (k2h first) would give plausible images and fail here."""
    iv = sp["vars"][0]["params"]
    sd = sp["models"][0].state_dict()
    for f in (1, 2):
        for i, head in enumerate(("head1h", "head1v", "head2h", "head2v"), 1):
            w = iv[f"{head}_f{f}"]["conv3"]["Conv_0"]["kernel"]
            np.testing.assert_array_equal(
                sd[f"upconv51_{f}{i}.7.weight"].numpy(),
                np.transpose(w, (3, 2, 0, 1)))


def test_reference_sp_checkpoint_loads(sp):
    """A reference SP IFNet checkpoint: ``module.`` prefixes, a
    ``model_weights`` payload and the eight unused heads
    (``upconv51_15..18``, ``_25..28``), which load_reference drops."""
    sd = {f"module.{k}": v for k, v in sp["models"][0].state_dict().items()}
    for f in (1, 2):
        for i in (5, 6, 7, 8):
            sd[f"module.upconv51_{f}{i}.0.weight"] = torch.zeros(1)
    model = load_reference(port_module("IFNet", K, 2), {"model_weights": sd})
    for k, v in model.state_dict().items():
        assert torch.equal(v, sp["models"][0].state_dict()[k]), k


def test_sp_pipeline_float32_matches_jax(sp):
    vfi, denoise, fusion = sp["models"]
    pipe = SPPipeline(vfi, denoise, fusion, device="cpu")
    got = pipe.restore(*sp["quartet"])
    want = sp["want"]["pipeline"]
    assert set(got) == set(want) == set(OUTPUTS)
    for k in OUTPUTS:
        g = got[k].numpy()
        assert g.shape == want[k].shape == (1, 64, 64), k
        np.testing.assert_allclose(g, want[k], rtol=0, atol=1e-3, err_msg=k)


def test_sp_pipeline_packed_bf16_matches_jax(sp):
    """The packed path (UNetSP and FusionNetSP on the conv and pool kernels'
    plain versions, IFNet as a bf16 module) against the JAX float32
    results."""
    import copy

    models = [copy.deepcopy(m) for m in sp["models"]]
    pipe = SPPipeline(*models, device="cpu", dtype=SERVING_DTYPE,
                      packed_conv=True)
    got = pipe.restore(*sp["quartet"])
    want = sp["want"]["pipeline"]
    for k in OUTPUTS:
        g, w = got[k].double().numpy(), want[k].astype(np.float64)
        nrmse = float(np.sqrt(np.mean((g - w) ** 2)) / (w.std() + 1e-6))
        assert nrmse < 0.05, (k, nrmse)


def test_sp_pipeline_refusals(sp):
    vfi, denoise, fusion = sp["models"]
    with pytest.raises(ValueError, match="bfloat16 only"):
        SPPipeline(vfi, denoise, fusion, device="cpu", packed_conv=True)
    with skip_init(), pytest.raises(ValueError, match="n_frames=2"):
        SPPipeline(IFNet(K), device="cpu")
    with pytest.raises(ValueError, match="denoise_model"):
        SPPipeline(vfi, device="cpu").restore(*sp["quartet"])


def test_sp_fusion_cli_matches_jax_cli(sp):
    """Both CLIs on the same reference-format checkpoints and PNGs (the JAX
    CLI ran in the fixture)."""
    folder, args = sp["cli"]
    port_cli.main(args + ["-sp", str(folder / "port"), "--device", "cpu"])
    for name in ("pred1.png", "pred2.png"):
        a = np.asarray(Image.open(folder / "port" / name), np.int32)
        b = np.asarray(Image.open(folder / "jax" / name), np.int32)
        assert a.shape == b.shape == (64, 64)
        assert np.abs(a - b).max() <= 1, (name, np.abs(a - b).max())
