"""The port's SFF correction and fusion training (sstem_tpu_torch:
cli/_sff.epe_valid_loop, train/loop and train/checkpoint with the
optimizer's state, cli/train_unfolding, cli/train_fusion,
train/device_datagen's steps, and train_interp's --device-datagen) vs the
JAX package.

One unfolding step and one fusion step at shared weights (the numpy
variables of tests/_torch_port.py, FusionNet ngf 4, 32^2, batch 2) are held
against one JAX program that computes both steps' losses and gradients, the
only JAX compile in this file. Both sides run these two steps in float64,
as the JAX package's own training parity does
(tests/test_training_parity.py): in float32 the gradients of these
train-mode BatchNorm nets are ill-conditioned at such sizes (at 64^2 the
port's own float32 gradients differ from its float64 ones by up to 4% of a
tensor's max, JAX's by up to 10%), which would hide a real fault. The
port's float32 losses are held against them too. The trainers' ``main``
runs on the CPU in float32 at the JAX end-to-end tests' sizes (100^2 crops
to 64^2, ngf 4); no JAX trainer ``main`` runs.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from sstem_tpu import losses as jax_losses
from sstem_tpu.cli import _sff as jax_sff
from sstem_tpu.compat.torch_ckpt import load_torch_fusionnet, load_torch_unet_sff
from sstem_tpu.models import FusionNet as JaxFusionNet
from sstem_tpu.models import UNetSFF as JaxUNetSFF
from sstem_tpu.ops import spatial_transform as jax_spatial_transform
from sstem_tpu_torch import losses
from sstem_tpu_torch.cli import _sff, train_fusion, train_interp, train_unfolding
from sstem_tpu_torch.compat.weights import (
    fusionnet_state_dict_from_jax, load_reference, unet_sff_state_dict_from_jax,
)
from sstem_tpu_torch.data.synthetic import write_triplet_tree
from sstem_tpu_torch.ops.warp import spatial_transform
from sstem_tpu_torch.train.trainer import TrainState

from _torch_port import numpy_variables, port_module

torch.set_num_threads(1)

NGF = 4


@pytest.fixture(scope="module")
def shared():
    """The shared variables and batch, and both JAX steps' float64 losses
    and gradients from one compiled program."""
    fv = numpy_variables(JaxFusionNet(output_nc=2, ngf=NGF), 30, train=True)
    uv = numpy_variables(JaxUNetSFF(1), 31, train=True)
    rng = np.random.default_rng(32)
    x = rng.random((2, 32, 32, 6), dtype=np.float32)
    x[..., 1:3] = x[..., 0:1]  # the degraded channels are one gray image
    flow2 = rng.normal(0, 3, (2, 32, 32, 2)).astype(np.float32)
    clean = rng.random((2, 32, 32, 1), dtype=np.float32)
    flow_net, unet = JaxFusionNet(output_nc=2, ngf=NGF), JaxUNetSFF(1)

    def both(fp, fs, up, us, xb, fb, cb):
        def unfolding(params):
            pred, _ = flow_net.apply({"params": params, "batch_stats": fs},
                                     xb, train=True, mutable=["batch_stats"])
            return jax_losses.l1_loss(pred, fb)

        def fusion(params):
            # train_fusion.compose_forward's chain, the flow net in eval
            flow = jax.lax.stop_gradient(
                flow_net.apply({"params": fp, "batch_stats": fs}, xb,
                               train=False))
            warped = jax_spatial_transform(xb[..., 0:3], flow)
            pred, _ = unet.apply(
                {"params": params, "batch_stats": us},
                jnp.concatenate([warped, xb[..., 3:6]], -1), train=True,
                mutable=["batch_stats"])
            return jax_losses.l1_loss(pred, cb)

        return (jax.value_and_grad(unfolding)(fp),
                jax.value_and_grad(fusion)(up))

    jax.config.update("jax_enable_x64", True)
    try:
        args = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)),
            (fv["params"], fv["batch_stats"], uv["params"], uv["batch_stats"],
             x, flow2, clean))
        (uloss, ugrad), (floss, fgrad) = jax.device_get(jax.jit(both)(*args))
    finally:
        jax.config.update("jax_enable_x64", False)
    return dict(fv=fv, uv=uv, x=x, flow2=flow2, clean=clean,
                unfolding=(float(uloss), ugrad), fusion=(float(floss), fgrad))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _port_net(name, variables):
    if name == "FusionNet":
        model, to_sd = port_module("FusionNet", 6, 2, NGF), \
            fusionnet_state_dict_from_jax
    else:
        model, to_sd = port_module("UNetSFF"), unet_sff_state_dict_from_jax
    model.load_state_dict(to_sd(variables), strict=True)
    return model


def _assert_step_matches(step_loss, model, importer, want_loss, want_grad):
    """``step_loss(model)``: the port's float32 loss within 1e-5 relative of
    JAX's float64 one; then in float64, the loss within 1e-5 relative and
    every parameter's gradient within 1e-4 of its tensor's max |gradient|
    (sums in different orders). A conv bias that feeds a train-mode BN has a
    gradient of exactly 0 (the BN subtracts the batch mean); both sides
    leave float64 cancellation noise (~1e-18) there, so its bound is 1e-12
    absolute."""
    with torch.no_grad():
        loss32 = step_loss(model).item()
    np.testing.assert_allclose(loss32, want_loss, rtol=1e-5, atol=0)
    model.double().zero_grad(set_to_none=True)
    loss = step_loss(model)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5, atol=0)
    grads = {k: v for k, v in model.state_dict().items()}
    grads.update({k: p.grad for k, p in model.named_parameters()})
    got = importer(grads)["params"]
    leaves = jax.tree_util.tree_leaves_with_path(want_grad)
    assert len(leaves) == len(list(model.parameters()))
    for path, want in leaves:
        have = got
        for key in path:
            have = have[key.key]
        want = np.asarray(want)
        np.testing.assert_allclose(have, want, rtol=0,
                                   atol=max(1e-4 * np.abs(want).max(), 1e-12),
                                   err_msg=jax.tree_util.keystr(path))


def test_unfolding_step_matches_jax(shared):
    """``train_unfolding``'s loss (L1 on the flow, FusionNet in train mode)
    and its gradients against JAX's at shared weights and batch."""
    x, flow2 = _nchw(shared["x"]), _nchw(shared["flow2"])

    def step_loss(model):
        dt = next(model.parameters()).dtype
        return losses.l1_loss(model(x.to(dt)), flow2.to(dt))

    _assert_step_matches(step_loss, _port_net("FusionNet", shared["fv"]).train(),
                         load_torch_fusionnet, *shared["unfolding"])


def test_fusion_step_matches_jax_and_keeps_the_flow_net_frozen(shared,
                                                               monkeypatch):
    """``train_fusion.compose_forward``'s loss and the U-Net's gradients
    against JAX's chain (eval-mode flow net, zero-border warp of the three
    degraded channels, U-Net in train mode); the warp is serving_warp's
    plain version, which it runs on the CPU, called directly because the
    wrapper takes float32 only; then a whole float32 step of ``build``'s
    train step leaves the flow net's parameters and BN running statistics
    unchanged and its mode eval."""
    monkeypatch.setattr(train_fusion, "serving_warp", spatial_transform)
    x, clean = _nchw(shared["x"]), _nchw(shared["clean"])
    flow_net = _port_net("FusionNet", shared["fv"]).eval().requires_grad_(False)

    def step_loss(unet):
        dt = next(unet.parameters()).dtype
        flow_net.to(dt)
        return losses.l1_loss(
            train_fusion.compose_forward(flow_net, unet, x.to(dt)),
            clean.to(dt))

    _assert_step_matches(step_loss, _port_net("UNetSFF", shared["uv"]).train(),
                         load_torch_unet_sff, *shared["fusion"])

    flow_net.float()
    monkeypatch.undo()
    cfg = _cfg("fusion_step", {"output_nc": 1}, "unused")
    before = copy.deepcopy(flow_net.state_dict())
    unet, opt, step, _, _ = train_fusion.build(cfg, flow_net, "cpu", seed=1)
    state, metrics = step(TrainState(unet, opt), (x, clean))
    assert np.isfinite(float(metrics["loss"])) and opt.count == 1
    assert not flow_net.training and unet.training
    for k, v in flow_net.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in flow_net.parameters())


def test_epe_valid_loop_matches_jax():
    """The mean EPE over a map-style flow set (channels first in the port,
    channels last in JAX) of the same prediction function: within 1e-6
    relative."""
    rng = np.random.default_rng(33)
    items = [(rng.random((6, 24, 32), dtype=np.float32),
              rng.normal(0, 2, (2, 24, 32)).astype(np.float32))
             for _ in range(3)]
    jax_items = [(a.transpose(1, 2, 0), b.transpose(1, 2, 0))
                 for a, b in items]
    got = _sff.epe_valid_loop(lambda x: x[:, 1:3] * 4.0 - 2.0, items, "cpu")
    want = jax_sff.epe_valid_loop(lambda v, x: x[..., 1:3] * 4.0 - 2.0, None,
                                  jax_items)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the trainers' main on the CPU
# ---------------------------------------------------------------------------

AUG = {"random_fliplr": True, "random_flipud": True, "random_flipz": True,
       "random_rotation": True, "swap": True, "color_jitter": False,
       "COLOR": {"brightness": 0.2, "contrast": 0.2, "saturation": 0.2},
       "elastic_trans": False,
       "ELASTIC": {"alpha_range": 100, "sigma": 10, "shave": 20},
       "gauss_noise": False, "GAUSS": {"gauss_mean": 0, "gauss_sigma": 0.001}}


def _cfg(name, train, folder, root=None, data=None):
    """An SFF trainer config at the JAX end-to-end tests' sizes (crop 100 ->
    det 64, ngf 4, batch 2, K 5); written under ``root`` when given."""
    cfg = {"NAME": name,
           "TRAIN": {"resume": False, "if_valid": False,
                     "cache_path": os.path.join(str(root), "caches"),
                     "save_path": os.path.join(str(root), "models"),
                     "input_nc": 6, "output_nc": 2, "ngf": NGF, "loss": "L1",
                     "kernel_size": 5, "total_iters": 2, "warmup_iters": 1,
                     "base_lr": 1e-3, "end_lr": 1e-4, "decay_iters": 100,
                     "power": 1.5, "weight_decay": 1e-4, "display_freq": 1,
                     "valid_freq": 1, "save_freq": 1, "batch_size": 2,
                     "random_seed": 555, **train},
           "DATA": {"folder_name": folder, "train_txt": "train_data.txt",
                    "interp_train_txt": "interp_train_data.txt",
                    "patch_size": [100, 100], "det_size": 64, "AUG": AUG,
                    **(data or {})}}
    if root is None:
        from sstem_tpu_torch.compat.config import AttrDict

        return AttrDict(cfg)
    path = os.path.join(str(root), name + ".yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """3 triplets of 160^2, their interp list (the clean middle sections
    stand in for interp images), and a valid list for each trainer: the
    unfolding one with flow2 in HDF5 sidecars."""
    import h5py

    root = tmp_path_factory.mktemp("sff_train")
    data = str(root / "data")
    rows = [r.split() for r in write_triplet_tree(data, 3, 160, seed=34)]
    with open(os.path.join(data, "interp_train_data.txt"), "w") as f:
        f.write("\n".join(r[1] for r in rows) + "\n")
    flow = np.random.default_rng(35).normal(0, 3, (160, 160, 2))
    with h5py.File(os.path.join(data, "flow.hdf"), "w") as f:
        f.create_dataset("flow2", data=flow.astype(np.float32))
    with open(os.path.join(data, "valid_unfolding.txt"), "w") as f:
        f.write(f"{rows[0][0]} {rows[0][2]} flow.hdf\n")
    with open(os.path.join(data, "valid_fusion.txt"), "w") as f:
        f.write(f"{rows[0][0]} {rows[0][2]} {rows[0][1]}\n")
    return root, data


def _loss_lines(paths):
    with open(os.path.join(paths["cache_path"], "loss.txt")) as f:
        lines = f.read().splitlines()
    assert all(np.isfinite(float(ln.split("loss = ")[1].split()[0]))
               for ln in lines)
    return [ln.split(",")[0] for ln in lines]


@pytest.mark.parametrize("datagen", ["host", "device"])
def test_train_unfolding_main(tree, datagen, monkeypatch):
    """``train_unfolding.main --device cpu`` for 2 steps on each datagen
    path, validation on: loss.txt, valid.txt with EPE lines, the preview
    (host path), and reference checkpoints that load strictly into the
    port's FusionNet and, through the JAX importer, into the same leaves."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    root, data = tree
    cfg = _cfg(f"unfold_{datagen}", {"if_valid": True}, data, root,
               {"valid_txt": "valid_unfolding.txt"})
    flags = ["--device-datagen"] if datagen == "device" else []
    paths = train_unfolding.main(["-c", cfg, "--max-iters", "2",
                                  "--device", "cpu"] + flags)
    assert _loss_lines(paths) == ["step 1", "step 2"]
    with open(os.path.join(paths["cache_path"], "valid.txt")) as f:
        valid = f.read().splitlines()
    assert [v.split(",")[0] for v in valid] == ["model-1", "model-2"]
    assert all(np.isfinite(float(v.split("valid-epe=")[1])) for v in valid)
    previews = {"000001.png", "000002.png"} & set(os.listdir(paths["cache_path"]))
    assert len(previews) == (2 if datagen == "host" else 0)
    assert sorted(os.listdir(paths["save_path"])) == [
        "model-000001.ckpt", "model-000002.ckpt"]
    ckpt = os.path.join(paths["save_path"], "model-000002.ckpt")
    model = load_reference(port_module("FusionNet", 6, 2, NGF), ckpt)
    back = fusionnet_state_dict_from_jax(load_torch_fusionnet(ckpt))
    for k, v in back.items():
        if not k.endswith("num_batches_tracked"):  # not imported by JAX
            assert torch.equal(v, model.state_dict()[k]), k


def test_train_fusion_resume_equals_a_straight_run(tree, monkeypatch):
    """``train_fusion.main --device cpu --device-datagen`` (the pool on the
    device, the host streaming only the step counter) behind the unfolding
    run's flow checkpoint: 1 step, then ``--resume-from`` its save dir to
    step 2, gives the straight 2-step run's weights, Adam moments and step
    count exactly (CPU, one thread). The host datagen path runs too, with
    PSNR validation through the chain."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    root, data = tree
    flow_dir = os.path.join(root, "flow")
    os.makedirs(flow_dir, exist_ok=True)
    flow_net = port_module("FusionNet", 6, 2, NGF)
    torch.save({"model_weights": {f"module.{k}": v for k, v in
                                  flow_net.state_dict().items()}},
               os.path.join(flow_dir, "flow.ckpt"))
    train = {"output_nc": 1, "flownet_path": flow_dir, "flownet_id": "flow.ckpt"}
    runs = {}
    for name, iters, extra in (("straight", 2, []), ("first", 1, []),
                               ("resumed", 2, ["--resume-from"])):
        if extra:
            extra = extra + [runs["first"]["save_path"]]
        cfg = _cfg(f"fusion_{name}", train, data, root)
        runs[name] = train_fusion.main(
            ["-c", cfg, "--max-iters", str(iters), "--device", "cpu",
             "--device-datagen"] + extra)
    assert _loss_lines(runs["resumed"]) == ["step 2"]
    payloads = [torch.load(os.path.join(runs[n]["save_path"],
                                        "model-000002.ckpt"),
                           map_location="cpu", weights_only=True)
                for n in ("straight", "resumed")]
    for a, b in zip(*(p["model_weights"].items() for p in payloads)):
        assert a[0] == b[0] and torch.equal(a[1], b[1]), a[0]
    opt_a, opt_b = (p["optimizer_weights"] for p in payloads)
    assert opt_a["param_groups"] == opt_b["param_groups"]
    for i, s in opt_a["state"].items():
        assert int(s["step"]) == 2
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s[key], opt_b["state"][i][key]), (i, key)

    cfg = _cfg("fusion_host", {**train, "if_valid": True}, data, root,
               {"valid_txt": "valid_fusion.txt"})
    paths = train_fusion.main(["-c", cfg, "--max-iters", "1", "--device",
                               "cpu"])
    with open(os.path.join(paths["cache_path"], "valid.txt")) as f:
        assert f.read().startswith("model-1, valid-psnr=")
    assert os.path.exists(os.path.join(paths["cache_path"], "000001.png"))


def test_train_interp_device_datagen_main(tree, monkeypatch):
    """``train_interp.main --device-datagen --device cpu`` samples the
    triplet crops from the pool (frame swap on) for 2 steps: finite losses,
    no preview, a checkpoint; with a pixel augmentation on it falls back to
    host streaming."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    root, data = tree
    cfg = _cfg("interp_pool", {"output_nc": 1}, data, root,
               {"patch_size": [32, 32]})
    paths = train_interp.main(["-c", cfg, "--max-iters", "2", "--device",
                               "cpu", "--device-datagen"])
    assert _loss_lines(paths) == ["step 1", "step 2"]
    assert not [n for n in os.listdir(paths["cache_path"])
                if n.endswith(".png")]
    assert "model-000002.ckpt" in os.listdir(paths["save_path"])
