"""The port's interp training slice (sstem_tpu_torch: losses, schedules,
trainer, checkpoint, data, cli/train_interp) vs the JAX package.

Inputs are made with numpy from seeds and go to both sides; IFNet weights
are the numpy variables of tests/_torch_port.py. Each test states its
tolerance. The one JAX IFNet compile is the gradient of
``test_ifnet_l1_gradient_matches_jax``.
"""

import os
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
import optax

from sstem_tpu import losses as jax_losses
from sstem_tpu.compat.config import load_sff_config as jax_load_sff_config
from sstem_tpu.compat.torch_ckpt import load_torch_ifnet
from sstem_tpu.data import providers as jax_providers
from sstem_tpu.data.synthetic import write_triplet_tree as jax_write_triplet_tree
from sstem_tpu.models import IFNet as JaxIFNet
from sstem_tpu.train.schedules import poly_warmup_decay_lr as jax_poly_lr
from sstem_tpu.train.trainer import make_optimizer as jax_make_optimizer
from sstem_tpu_torch import losses
from sstem_tpu_torch.cli import train_interp
from sstem_tpu_torch.compat.config import load_sff_config
from sstem_tpu_torch.compat.weights import ifnet_state_dict_from_jax, load_reference
from sstem_tpu_torch.data import providers
from sstem_tpu_torch.data.synthetic import write_triplet_tree
from sstem_tpu_torch.metrics import compute_psnr
from sstem_tpu_torch.train.schedules import poly_warmup_decay_lr
from sstem_tpu_torch.train.trainer import make_optimizer

from _torch_port import ifnet_variables, port_module

torch.set_num_threads(1)

K = 5
ALL_AUGS = dict(swap=True, color_jitter=True, gauss_noise=True,
                elastic_trans=True, shave=8)


@pytest.fixture(scope="module")
def port_ifnet():
    """One IFNet(K) for the tests that load weights into it (its
    orthogonal init costs seconds on a CPU)."""
    return port_module("IFNet", K)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A triplet tree written by the JAX package's ``write_triplet_tree``."""
    root = str(tmp_path_factory.mktemp("tree"))
    rows = jax_write_triplet_tree(root, n_triplets=3, size=64, seed=4)
    with open(os.path.join(root, "valid_data.txt"), "w") as f:
        f.write(rows[0] + "\n")
    return root


@pytest.mark.parametrize("name", ["l1_loss", "l2_loss", "ssim_loss"])
def test_loss_matches_jax(name):
    """Scalar means of f32 maps: within 1e-6 abs (summation order; SSIM's
    blur runs as a grouped conv on both sides)."""
    rng = np.random.default_rng(1)
    pred = rng.random((2, 1, 24, 20), dtype=np.float32)
    target = rng.random((2, 1, 24, 20), dtype=np.float32)
    got = getattr(losses, name)(torch.from_numpy(pred), torch.from_numpy(target))
    want = getattr(jax_losses, name)(jnp.asarray(pred.transpose(0, 2, 3, 1)),
                                     jnp.asarray(target.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)


def test_poly_warmup_decay_lr_matches_jax():
    """Both evaluate in float32: within 1e-6 relative (one f32 power ulp)."""
    for args in [(1e-3, 1e-5, 10, 100, 1.5), (1e-4, 1e-6, 0, 50, 2.0),
                 (3e-4, 1e-5, 5, 5, 1.5)]:
        ours, theirs = poly_warmup_decay_lr(*args), jax_poly_lr(*args)
        for step in [0, 1, 3, 5, 9, 10, 11, 50, 99, 100, 150]:
            np.testing.assert_allclose(ours(step), float(theirs(step)),
                                       rtol=1e-6, atol=0)


@pytest.mark.parametrize("weight_decay", [None, 0.1])
def test_optimizer_matches_optax(weight_decay):
    """Six Adam or AdamW updates under a warmup schedule, update t at
    schedule(t) from t = 0, on one random vector: within 1e-6 abs (f32
    rounding of the moment arithmetic, over |p| ~ 1)."""
    rng = np.random.default_rng(2)
    p0 = rng.standard_normal(64).astype(np.float32)
    grads = rng.standard_normal((6, 64)).astype(np.float32)
    args = (1e-2, 1e-4, 3, 10, 1.5)

    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer([param], poly_warmup_decay_lr(*args),
                         weight_decay=weight_decay)
    tx = jax_make_optimizer(jax_poly_lr(*args), weight_decay=weight_decay)
    p = jnp.asarray(p0)
    state = tx.init(p)

    @jax.jit
    def update(g, state, p):
        updates, state = tx.update(g, state, p)
        return optax.apply_updates(p, updates), state

    for g in grads:
        param.grad = torch.from_numpy(g)
        opt.step()
        p, state = update(jnp.asarray(g), state, p)
    assert opt.count == 6
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(p),
                               rtol=0, atol=1e-6)


def test_interp_samples_equal_jax_with_all_augs(tree):
    """Same seed, same numpy streams: the port's samples (channels first)
    equal the JAX package's (channels last), exactly; so do the batches of
    a one-thread Provider."""
    kw = dict(patch_size=(40, 40))
    ours = providers.InterpTrainDataset(
        tree, aug=providers.AugConfig(**ALL_AUGS), **kw)
    theirs = jax_providers.InterpTrainDataset(
        tree, aug=jax_providers.AugConfig(**ALL_AUGS), **kw)
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(4):
        (im, lb), (jim, jlb) = ours.sample(r1), theirs.sample(r2)
        assert im.shape == (6, 24, 24) and lb.shape == (1, 24, 24)
        assert np.array_equal(im, jim.transpose(2, 0, 1))
        assert np.array_equal(lb, jlb.transpose(2, 0, 1))

    prov = providers.Provider(ours, 2, seed=3, num_threads=1)
    jprov = jax_providers.Provider(theirs, 2, seed=3, num_threads=1,
                                   device_put=False)
    try:
        for _ in range(2):
            (x, y), (jx, jy) = prov.next(), jprov.next()
            assert x.dtype == torch.float32 and x.shape == (2, 6, 24, 24)
            assert np.array_equal(x.numpy(), jx.transpose(0, 3, 1, 2))
            assert np.array_equal(y.numpy(), jy.transpose(0, 3, 1, 2))
    finally:
        prov.close()
        jprov.close()


def test_triplet_tree_and_config_match_jax(tree, tmp_path):
    """The port writes the JAX package's triplet tree byte for byte (both
    through Pillow), reads its PNGs as Pillow does, and loads a config as
    PyYAML and the JAX loader do."""
    root = str(tmp_path / "port_tree")
    write_triplet_tree(root, n_triplets=3, size=64, seed=4)
    for name in sorted(os.listdir(tree)):
        if name.endswith(".png"):
            with open(os.path.join(root, name), "rb") as a, \
                    open(os.path.join(tree, name), "rb") as b:
                assert a.read() == b.read(), name
            from PIL import Image

            want = np.asarray(Image.open(os.path.join(tree, name)))
            assert np.array_equal(providers._read_gray(os.path.join(tree, name)),
                                  want)
    cfg = {"NAME": "t", "TRAIN": {"base_lr": 1e-4, "weight_decay": None,
                                  "kernel_size": 51},
           "DATA": {"patch_size": [256, 256], "AUG": {"swap": False}}}
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    ours = load_sff_config(path)
    assert dict(ours) == dict(jax_load_sff_config(path)) == {**cfg, "path": path}
    assert ours.TRAIN.weight_decay is None and ours.DATA.AUG.swap is False


def test_compute_psnr_matches_reference_quirk():
    a = np.full((4, 4), 0.5)
    assert compute_psnr(a, a) == 1000000000000
    mse, psnr = compute_psnr(a, a + 0.1)
    np.testing.assert_allclose([mse, psnr], [0.01, 20.0])


def test_ifnet_l1_gradient_matches_jax(port_ifnet):
    """One L1 step's gradient, K=5, 32^2, batch 2, same weights and batch:
    the loss within 1e-6 and every parameter's gradient within 2e-5 of that
    tensor's max |gradient| (f32 on both sides, JAX at HIGHEST precision;
    convs and sepconv sum in different orders; the worst tensor measured
    1.7e-6)."""
    iv = ifnet_variables(K, seed=40)
    rng = np.random.default_rng(41)
    x = rng.random((2, 32, 32, 6), dtype=np.float32)
    y = rng.random((2, 32, 32, 1), dtype=np.float32)
    model = JaxIFNet(kernel_size=K, n_frames=1)

    def loss_fn(params, xb, yb):
        return jax_losses.l1_loss(model.apply({"params": params}, xb), yb)

    jloss, jgrad = jax.jit(jax.value_and_grad(loss_fn))(
        iv["params"], jnp.asarray(x), jnp.asarray(y))

    port = port_ifnet
    port.load_state_dict(ifnet_state_dict_from_jax(iv), strict=True)
    port.zero_grad(set_to_none=True)
    loss = losses.l1_loss(port(torch.from_numpy(x.transpose(0, 3, 1, 2))),
                          torch.from_numpy(y.transpose(0, 3, 1, 2)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=0, atol=1e-6)
    got = load_torch_ifnet({k: p.grad for k, p in port.named_parameters()})

    leaves = jax.tree_util.tree_leaves_with_path(jgrad)
    assert len(leaves) == len(list(port.parameters()))
    for path, want in leaves:
        have = got["params"]
        for key in path:
            have = have[key.key]
        want = np.asarray(want)
        np.testing.assert_allclose(have, want, rtol=0,
                                   atol=2e-5 * np.abs(want).max(),
                                   err_msg=jax.tree_util.keystr(path))


def test_train_interp_main_writes_reference_checkpoints(port_ifnet, tree,
                                                       tmp_path, monkeypatch):
    """``train_interp.main`` on the CPU for 2 steps, all augs on, SSIM loss,
    AdamW, validation at step 1: it writes loss.txt, valid.txt and (at the
    last step) model-000002.ckpt, which loads strictly into the port's IFNet
    and, through the JAX package's importer, into the same leaves. It runs
    without the optional tensorboardX (whose import alone takes seconds)."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    aug = {"random_fliplr": True, "random_flipud": True, "random_flipz": True,
           "random_rotation": True, "swap": True, "color_jitter": True,
           "COLOR": {"brightness": 0.2, "contrast": 0.2, "saturation": 0.2},
           "elastic_trans": True,
           "ELASTIC": {"alpha_range": 100, "sigma": 10, "shave": 8},
           "gauss_noise": True, "GAUSS": {"gauss_mean": 0, "gauss_sigma": 0.001}}
    cfg = {"NAME": "interp_t",
           "TRAIN": {"resume": False, "if_valid": True,
                     "cache_path": str(tmp_path / "caches"),
                     "save_path": str(tmp_path / "models"),
                     "loss": "ssim", "kernel_size": K, "total_iters": 10,
                     "warmup_iters": 1, "base_lr": 1e-3, "end_lr": 1e-4,
                     "decay_iters": 100, "power": 1.5, "weight_decay": 1e-4,
                     "display_freq": 1, "valid_freq": 1000, "save_freq": 1000,
                     "batch_size": 2, "random_seed": 555},
           "DATA": {"folder_name": tree, "train_txt": "train_data.txt",
                    "valid_txt": "valid_data.txt", "patch_size": [48, 48],
                    "AUG": aug}}
    path = str(tmp_path / "interp.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    paths = train_interp.main(["-c", path, "--max-iters", "2",
                               "--device", "cpu"])

    with open(os.path.join(paths["cache_path"], "loss.txt")) as f:
        lines = f.read().splitlines()
    assert [ln.split(",")[0] for ln in lines] == ["step 1", "step 2"]
    assert all(np.isfinite(float(ln.split("loss = ")[1].split()[0]))
               for ln in lines)
    with open(os.path.join(paths["cache_path"], "valid.txt")) as f:
        assert f.read().startswith("model-1, valid-psnr=")
    assert os.listdir(paths["save_path"]) == ["model-000002.ckpt"]

    ckpt = os.path.join(paths["save_path"], "model-000002.ckpt")
    payload = torch.load(ckpt, map_location="cpu", weights_only=True)
    assert payload["current_iter"] == 2
    sd = load_reference(port_ifnet, ckpt).state_dict()
    back = ifnet_state_dict_from_jax(load_torch_ifnet(ckpt))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
