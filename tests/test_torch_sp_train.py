"""The port's SP training (sstem_tpu_torch: compat/config's NoneDict and
load_sp_config, train/schedules.step_lr, data/providers' SPDataset and dict
batches, per-group schedules in train/trainer.Optimizer, and the CLIs
train_sp_interp, train_sp_correction and train_sp_fusion) vs the JAX
package; and the SFF pipeline's packed_conv routing at a flow width other
than 32.

Shared weights are the numpy variables of tests/_torch_port.py (K=5), the
batch is 2 SPDataset crops of 32^2 from a seeded quartet tree, and the loss
crop PAD is 2. The JAX side is one module fixture with two compiles: the
interp step's loss and gradients in float32, and the correction and fusion
steps' losses, gradients and BN statistics in float64. Those two steps run
their train-mode BatchNorm nets in float64 on both sides, as
tests/test_torch_sff_train.py does and for its reason: in float32 such
gradients at these sizes differ from float64 by percents of a tensor's
max, which would hide a fault. The JAX sepconv accumulates in float32
whatever its input's dtype (sstem_tpu/kernels/sepconv.py:72-75); the port's
plain version accumulates a float64 input in float64. The port's steps run
through each trainer's ``build``, and their gradients are read from the
parameters after the step. The trainers' ``main`` runs on the CPU at the
same sizes; no JAX trainer ``main`` runs.
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
from sstem_tpu.cli.train_sp_fusion import sp_fusion_forward as jax_sp_fusion_forward
from sstem_tpu.cli.train_sp_fusion import sp_masks as jax_sp_masks
from sstem_tpu.cli.train_sp_interp import vfi_inputs as jax_vfi_inputs
from sstem_tpu.compat.config import load_sp_config as jax_load_sp_config
from sstem_tpu.compat.torch_ckpt import load_torch_ifnet, load_torch_unet_sp
from sstem_tpu.data import providers as jax_providers
from sstem_tpu.models import FusionNetSP as JaxFusionNetSP
from sstem_tpu.models import IFNet as JaxIFNet
from sstem_tpu.models import UNetSP as JaxUNetSP
from sstem_tpu.ops import negative_pad_2d as jax_negative_pad_2d
from sstem_tpu.train.schedules import step_lr as jax_step_lr
from sstem_tpu_torch import config
from sstem_tpu_torch.cli import train_sp_correction, train_sp_fusion, train_sp_interp
from sstem_tpu_torch.compat.config import NoneDict, load_sp_config
from sstem_tpu_torch.compat.weights import (
    ifnet_state_dict_from_jax, unet_sp_state_dict_from_jax,
)
from sstem_tpu_torch.data import providers
from sstem_tpu_torch.data.synthetic import write_quartet_tree
from sstem_tpu_torch.infer.pipeline import SFFPipeline
from sstem_tpu_torch.models.layers import skip_init
from sstem_tpu_torch.train.schedules import step_lr
from sstem_tpu_torch.train.trainer import TrainState

from _torch_port import port_module, sp_variables

torch.set_num_threads(1)

K = 5
PAD = 2
PATCH = 32
SIZE = 48
# the batch's draws: one whose ReLU inputs keep their signs in float32
# (test_interp_step_matches_jax)
BATCH_SEED = 53


def _jax_batch(ds, seed, n=2):
    rng = np.random.default_rng(seed)
    samples = [ds.sample(rng) for _ in range(n)]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _port_batch(batch, dtype=torch.float32):
    return {k: torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2)))
            .to(dtype) for k, v in batch.items()}


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """The quartet tree, the shared variables and batch, and the JAX steps:
    in float64 from one program, the fusion step's loss (mode b, all six
    terms) and the correction step's, which is the fusion step's denoise
    terms (its two chained train-mode applications of the denoising U-Net
    included), with both losses' gradients by one batched backward and the
    BN statistics; then the interp step's float32 loss and gradients. (The
    JAX IFNet runs its sepconvs in float32 at any input dtype,
    sstem_tpu/kernels/sepconv.py:72-75.) The programs are dispatched here
    and run in the background (JAX's asynchronous dispatch); ``_steps``
    waits for their results, so the tests that do not need them (the
    trainers' ``main`` among them) run meanwhile."""
    root = str(tmp_path_factory.mktemp("sp_tree"))
    txt = write_quartet_tree(root, 2, SIZE, seed=50)
    iv, dv, fv = sp_variables(K, seed=51)
    ds = jax_providers.SPDataset(root, txt, patch_size=PATCH)
    batch = _jax_batch(ds, BATCH_SEED)
    vfi, unet, fusion = JaxIFNet(K, n_frames=2), JaxUNetSP(1), JaxFusionNetSP(1)

    def crop(x):
        return jax_negative_pad_2d(x, PAD)

    def joint(params, dstats, fstats, b):
        p1, p2, (v1, v2), (d1, d2), new_bs = jax_sp_fusion_forward(
            (vfi, unet, fusion),
            {"params": params,
             "batch_stats": {"denoise": dstats, "fusion": fstats}},
            b, "b", train=True)
        t1, t2 = crop(b["img_2"]), crop(b["img_3"])
        l1 = jax_losses.l1_loss
        lv = l1(crop(v1), t1) + l1(crop(v2), t2)
        ld = l1(crop(d1), t1) + l1(crop(d2), t2)
        lf = l1(crop(p1), t1) + l1(crop(p2), t2)
        return jnp.stack([ld, lv + ld + lf]), new_bs

    def both(params, dstats, fstats, b):
        out, pull, new_bs = jax.vjp(
            lambda p: joint(p, dstats, fstats, b), params, has_aux=True)
        return out, new_bs, jax.vmap(pull)(jnp.eye(2, dtype=out.dtype))[0]

    jax.config.update("jax_enable_x64", True)
    try:
        args = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)),
            ({"vfi": iv["params"], "denoise": dv["params"],
              "fusion": fv["params"]}, dv["batch_stats"], fv["batch_stats"],
             batch))
        steps64 = jax.jit(both)(*args)
    finally:
        jax.config.update("jax_enable_x64", False)

    def interp_loss(params, b):
        pred = vfi.apply({"params": params}, jax_vfi_inputs(b))
        return (jax_losses.l1_loss(crop(pred[..., 0:1]), crop(b["img_2"]))
                + jax_losses.l1_loss(crop(pred[..., 1:2]), crop(b["img_3"])))

    interp = jax.jit(jax.value_and_grad(interp_loss))(iv["params"], batch)
    return dict(root=root, txt=txt, variables=(iv, dv, fv), batch=batch,
                interp=interp, steps64=steps64)


def _steps(shared, name):
    """The JAX step ``name`` ('interp', 'correction' or 'joint') as host
    arrays: ((loss, BN statistics), gradients), or (loss, gradients) for
    the interp step."""
    if name == "interp":
        return jax.device_get(shared["interp"])
    out, new_bs, grads = jax.device_get(shared["steps64"])

    def term(i, tree):
        return jax.tree_util.tree_map(lambda g: g[i], tree)

    if name == "correction":
        return (out[0], new_bs["denoise"]), term(0, grads["denoise"])
    return (out[1], new_bs), term(1, grads)


def _cfg(**kw):
    return NoneDict({"kernel_size": K, "base_lr": 1e-4, "PAD": PAD, **kw})


def _leaves_close(got, want, rtol_of_max, floor=0.0):
    """Every leaf of ``want`` (a JAX tree) against ``got`` (the same tree
    from the port) within ``rtol_of_max`` of that leaf's max |value|."""
    leaves = jax.tree_util.tree_leaves_with_path(want)
    for path, w in leaves:
        have = got
        for key in path:
            have = have[key.key]
        w = np.asarray(w)
        err = np.abs(np.asarray(have) - w).max()
        tol = max(rtol_of_max * np.abs(w).max(), floor)
        assert err <= tol, (jax.tree_util.keystr(path), err, tol)
    return len(leaves)


def _grads(module):
    """The module's state dict with each parameter's gradient in its place
    (the JAX importers read the buffers too)."""
    sd = dict(module.state_dict())
    sd.update({k: p.grad for k, p in module.named_parameters()})
    return sd


@pytest.mark.parametrize("steps_per_epoch", [1, 3])
def test_step_lr_matches_jax(steps_per_epoch):
    """``step_lr`` equals the JAX schedule exactly across the first decays,
    at the fusion trainer's smallest branch weight too."""
    for base in (1e-4, 1e-4 * 1e-20):
        want = jax_step_lr(base, 30, 0.5, steps_per_epoch=steps_per_epoch)
        got = step_lr(base, 30, 0.5, steps_per_epoch=steps_per_epoch)
        for step in (0, 29, 30, 59, 60, 95):
            assert got(step) == float(want(step)), (base, step)


def test_sp_config_matches_jax(tmp_path):
    """``load_sp_config`` reads what the JAX loader reads; missing keys give
    None and nested dicts become NoneDicts, as in JAX."""
    cfg = {"base_lr": 1e-4, "mode": "b", "PAD": 0, "nested": {"a": 1}}
    path = str(tmp_path / "sp.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    ours, theirs = load_sp_config(path), jax_load_sp_config(path)
    assert dict(ours) == dict(theirs) == cfg
    for c in (ours, theirs):
        assert c.missing is None and c.nested.a == 1 and c.nested.b is None
    assert isinstance(ours.nested, NoneDict)
    ours.vfi_last_iter = 3
    assert ours["vfi_last_iter"] == 3


def test_sp_dataset_and_provider_match_jax(shared, monkeypatch):
    """``SPDataset.sample`` gives the JAX one's arrays exactly (channels
    first), key by key, for the same numpy seed, with the dihedral, the
    color jitter and the vfi images on; a one-thread ``Provider`` yields the
    JAX provider's dict batches."""
    kw = dict(patch_size=PATCH, if_rotate=True, if_bdadjust=True, use_vfi=True)
    ours = providers.SPDataset(shared["root"], shared["txt"], **kw)
    theirs = jax_providers.SPDataset(shared["root"], shared["txt"], **kw)
    jitter = providers.augment.color_jitter
    jittered = []
    monkeypatch.setattr(providers.augment, "color_jitter",
                        lambda *a: jittered.append(1) or jitter(*a))
    rng_a, rng_b = np.random.default_rng(53), np.random.default_rng(53)
    for _ in range(12):
        a, b = ours.sample(rng_a), theirs.sample(rng_b)
        assert list(a) == list(b) == providers._SP_KEYS
        for k in a:
            assert a[k].dtype == np.float32 and a[k].shape == (1, PATCH, PATCH)
            assert np.array_equal(a[k][0], b[k][..., 0]), k
    assert jittered, "no sample drew the color jitter"
    p_ours = providers.Provider(ours, 2, seed=54, num_threads=1)
    p_theirs = jax_providers.Provider(theirs, 2, seed=54, num_threads=1,
                                      device_put=False)
    try:
        for _ in range(2):
            a, b = p_ours.next(), p_theirs.next()
            # the JAX provider's tree_map orders the keys
            assert isinstance(a, dict) and sorted(a) == sorted(b)
            for k in a:
                assert torch.equal(a[k], torch.from_numpy(
                    b[k].transpose(0, 3, 1, 2))), k
    finally:
        p_ours.close()
        p_theirs.close()


@pytest.mark.parametrize("mode", ["a", "b"])
def test_sp_masks_match_jax(shared, mode):
    got = train_sp_fusion.sp_masks(_port_batch(shared["batch"]), mode)
    want = jax_sp_masks(shared["batch"], mode)
    for g, w in zip(got, want):
        assert torch.equal(g, torch.from_numpy(
            np.asarray(w).transpose(0, 3, 1, 2)))


# ---------------------------------------------------------------------------
# the trainers' main on the CPU
# ---------------------------------------------------------------------------

def _write_cfg(root, name, **kw):
    """An SP trainer config at the tests' sizes; by default over a tree of
    one quartet of PATCH^2 (``one/``), without augmentations, so that every
    batch is the same and a resumed run sees the straight run's batches."""
    one = os.path.join(root, "one")
    cfg = {"data_folder": one,
           "data_txt": os.path.join(one, "sp_train_data.txt"),
           "patch_size": PATCH, "batch_size": 2, "kernel_size": K,
           "base_lr": 1e-4, "PAD": PAD, "random_seed": 55,
           "if_rotate": False, "if_bdadjust": False,
           "cache_path": os.path.join(root, "caches"),
           "save_path": os.path.join(root, "models", name),
           "valid_freq": 1, "save_freq": 1, **kw}
    path = os.path.join(root, name + ".yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _loss_steps(paths):
    with open(os.path.join(paths["cache_path"], "loss.txt")) as f:
        lines = f.read().splitlines()
    assert all(np.isfinite(float(ln.split("loss = ")[1].split()[0]))
               for ln in lines)
    return [ln.split(",")[0] for ln in lines]


def _payload(paths, step, branch=""):
    # memory-mapped: a tensor is read where the test reads it
    return torch.load(os.path.join(paths["save_path"], branch,
                                   "model-%06d.ckpt" % step),
                      map_location="cpu", weights_only=True, mmap=True)


@pytest.fixture(scope="module")
def interp_run(shared):
    """``train_sp_interp.main --device cpu`` for 2 steps, a checkpoint a
    step. The mains run without the optional tensorboardX (whose import
    alone takes seconds)."""
    write_quartet_tree(os.path.join(shared["root"], "one"), 1, PATCH, seed=58)
    cfg = _write_cfg(shared["root"], "interp", if_use_vfiImg=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorboardX", None)
        return cfg, train_sp_interp.main(["-opt", cfg, "--max-iters", "2",
                                          "--device", "cpu"])


def test_train_sp_interp_main_and_resume_torch(interp_run, monkeypatch):
    """The 2-step run writes loss.txt, a 3-row preview a step and
    reference checkpoints with the optimizer's state; resumed with
    ``--resume-torch`` from its step-1 checkpoint, a run to step 2 gives
    the straight run's weights, Adam moments and step counts exactly (CPU,
    one thread)."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    cfg, straight = interp_run
    assert _loss_steps(straight) == ["step 1", "step 2"]
    from PIL import Image

    preview = np.asarray(Image.open(os.path.join(straight["cache_path"],
                                                 "000002.png")))
    assert preview.shape == (3 * PATCH, 2 * PATCH)
    assert sorted(os.listdir(straight["save_path"])) == [
        "model-000001.ckpt", "model-000002.ckpt"]
    resumed = train_sp_interp.main(
        ["-opt", cfg, "--max-iters", "2", "--device", "cpu", "--resume-torch",
         os.path.join(straight["save_path"], "model-000001.ckpt")])
    assert _loss_steps(resumed) == ["step 2"]
    a, b = _payload(straight, 2), _payload(resumed, 2)
    assert a["current_iter"] == b["current_iter"] == 2
    for (ka, va), (kb, vb) in zip(a["model_weights"].items(),
                                  b["model_weights"].items()):
        assert ka == kb and torch.equal(va, vb), ka
    opt_a, opt_b = a["optimizer_weights"], b["optimizer_weights"]
    assert opt_a["param_groups"] == opt_b["param_groups"]
    for i, s in opt_a["state"].items():
        assert int(s["step"]) == 2
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s[key], opt_b["state"][i][key]), (i, key)


def test_train_sp_correction_and_fusion_main(shared, interp_run, monkeypatch):
    """``train_sp_correction.main`` for 2 steps (a checkpoint with the
    optimizer's state), then ``train_sp_fusion.main`` for 2 steps with the
    vfi and denoise branches pretrained from the interp and correction
    runs' step-2 checkpoints (under ``resume_path/{vfi,denoise}``), both
    branch weights 1e-20: its step checkpoints hold the three branches and
    no optimizer state, one checkpoint per branch lands under
    ``save_path/{vfi,denoise,fusion}``, and the pretrained branches'
    parameters are the loaded checkpoints' (their BN running statistics
    move in train mode)."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    root = shared["root"]
    correction = train_sp_correction.main(
        ["-opt", _write_cfg(root, "correction", save_freq=1000),
         "--max-iters", "2", "--device", "cpu"])
    assert _loss_steps(correction) == ["step 1", "step 2"]
    assert os.listdir(correction["save_path"]) == ["model-000002.ckpt"]
    assert "optimizer_weights" in _payload(correction, 2)

    pretrained = os.path.join(root, "pretrained")
    os.makedirs(pretrained)
    os.symlink(interp_run[1]["save_path"], os.path.join(pretrained, "vfi"))
    os.symlink(correction["save_path"], os.path.join(pretrained, "denoise"))
    cfg = _write_cfg(root, "fusion", data_folder=root, data_txt=shared["txt"],
                     if_rotate=True, if_bdadjust=True, save_freq=1000,
                     mode="a", vfi_lr_weight=1e-20, denoise_lr_weight=1e-20,
                     if_pretrained=True, resume_path=pretrained,
                     if_pretrained_vfi=True, if_pretrained_denoise=True,
                     vfi_last_iter=2, denoise_last_iter=2)
    fusion = train_sp_fusion.main(["-opt", cfg, "--max-iters", "2",
                                   "--device", "cpu"])
    assert _loss_steps(fusion) == ["step 1", "step 2"]
    assert os.path.exists(os.path.join(fusion["cache_path"], "000002.png"))
    assert sorted(os.listdir(fusion["save_path"])) == [
        "denoise", "fusion", "model-000002.ckpt", "vfi"]
    step2 = _payload(fusion, 2)
    assert "optimizer_weights" not in step2
    assert {k.split(".")[0] for k in step2["model_weights"]} == {
        "vfi", "denoise", "fusion"}
    for branch, run in (("vfi", interp_run[1]), ("denoise", correction)):
        loaded = _payload(run, 2)["model_weights"]
        saved = _payload(fusion, 2, branch)["model_weights"]
        assert sorted(saved) == sorted(loaded)
        for k, v in saved.items():
            if not k.endswith(("running_mean", "running_var",
                               "num_batches_tracked")):
                assert torch.equal(v, loaded[k]), (branch, k)
    assert "model_weights" in _payload(fusion, 2, "fusion")


def test_sff_pipeline_packed_conv_at_another_flow_width(caplog):
    """``SFFPipeline(..., packed_conv=True)`` with a FusionNet of ngf 8
    builds on the cuDNN path with one warning naming the width, as the JAX
    pipeline turns ``packed_conv`` off when ``ngf != 32``
    (sstem_tpu/infer/pipeline.py:79-80); its restore equals the
    packed_conv=False bfloat16 pipeline's exactly (the same seeded
    modules, copied)."""
    rng = np.random.default_rng(57)
    deg = rng.integers(0, 256, (1, 40, 56), dtype=np.uint8)
    interp = rng.integers(0, 256, (1, 40, 56), dtype=np.uint8)
    out = []
    for packed in (True, False):
        with caplog.at_level("WARNING"):
            pipe = SFFPipeline(None, port_module("FusionNet", 6, 2, 8),
                               port_module("UNetSFF"), "cpu",
                               dtype=config.SERVING_DTYPE, packed_conv=packed)
        assert not pipe.packed_conv
        out.append(pipe.restore(deg, interp))
    assert [r.getMessage() for r in caplog.records if "8 wide" in
            r.getMessage()] and len(caplog.records) == 1
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k


# ---------------------------------------------------------------------------
# one step of each trainer against JAX (after the mains, which run while the
# JAX programs do)
# ---------------------------------------------------------------------------

def _relu_inputs(model, x):
    """Every ReLU input of one forward of ``model`` on ``x``."""
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append(i[0]))
             for m in model.modules() if isinstance(m, torch.nn.ReLU)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return seen


def test_interp_step_matches_jax(shared):
    """One ``train_sp_interp`` step (IFNet K=5, two frames, float32, no BN):
    the loss within 1e-6 and every gradient within 2e-5 of its tensor's max
    |gradient|, the bounds of the one-frame step
    (tests/test_torch_train.py). Their premise is that both sides take the
    same path through every ReLU. A ReLU input within float32 rounding of 0
    (the two-frame net has some 10^6) can take the other side in one
    implementation, which moves a gradient by up to 2e-3 of its tensor's
    max, both sides being sound: the first batch drawn had one at 7.8e-8
    in the port's float32 and -6.4e-8 in float64, where JAX's float32
    matched float64 (2 of 10 draws have one). So the test first asserts
    that no ReLU input of the port's float32 forward has another sign than
    in its float64 forward."""
    iv = shared["variables"][0]
    with skip_init():
        model, opt, step, _, _ = train_sp_interp.build(_cfg(), 1, "cpu")
    model.load_state_dict(ifnet_state_dict_from_jax(iv, 2), strict=True)
    batch = _port_batch(shared["batch"])
    x = train_sp_interp.vfi_inputs(batch)
    flips = sum(int(((a > 0) != (b > 0)).sum()) for a, b in zip(
        _relu_inputs(model, x), _relu_inputs(copy.deepcopy(model).double(),
                                             x.double())))
    assert flips == 0, f"{flips} ReLU inputs change sign in float32"
    _, metrics = step(TrainState(model, opt), batch)
    want_loss, want_grad = _steps(shared, "interp")
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss),
                               rtol=0, atol=1e-6)
    got = load_torch_ifnet(_grads(model), n_frames=2)["params"]
    assert _leaves_close(got, want_grad, 2e-5) == len(list(model.parameters()))
    assert opt.count == 1


def _assert_bn_stats(module, want):
    got = load_torch_unet_sp(dict(module.state_dict()))["batch_stats"]
    _leaves_close(got, want, 0.0, floor=1e-6)


def test_correction_step_matches_jax(shared):
    """One ``train_sp_correction`` step in float64: the loss within 1e-5
    relative, every gradient within 1e-4 of its tensor's max (1e-12
    absolute for the conv biases that feed a train-mode BN, whose true
    gradient is 0), and the BN running statistics after the two chained
    applications within 1e-6."""
    _, dv, _ = shared["variables"]
    (want_loss, want_stats), want_grad = _steps(shared, "correction")
    with skip_init():
        model, opt, step, _, _ = train_sp_correction.build(_cfg(), 1, "cpu")
    model.load_state_dict(unet_sp_state_dict_from_jax(dv), strict=True)
    model.double()
    _, metrics = step(TrainState(model, opt),
                      _port_batch(shared["batch"], torch.float64))
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss),
                               rtol=1e-5, atol=0)
    got = load_torch_unet_sp(_grads(model))["params"]
    _leaves_close(got, want_grad, 1e-4, floor=1e-12)
    _assert_bn_stats(model, want_stats)


def test_fusion_step_matches_jax(shared):
    """One ``train_sp_fusion`` step (mode b, all six L1 terms) in float64:
    the loss within 1e-5 relative, every branch's gradients within 1e-4 of
    each tensor's max (1e-12 absolute floor, as above), both U-Nets' BN
    running statistics after their chained applications within 1e-6; each
    branch's Adam group at base_lr times its weight. (That the VFI branch's
    float32 parameters come out of a step bit for bit as they were is
    held in test_train_sp_correction_and_fusion_main.)"""
    iv, dv, fv = shared["variables"]
    (want_loss, want_stats), want_grad = _steps(shared, "joint")
    cfg = _cfg(mode="b", vfi_lr_weight=1e-20, denoise_lr_weight=1e-6)
    with skip_init():
        model, opt, step, _, _ = train_sp_fusion.build(cfg, 1, "cpu")
    for branch, sd in (("vfi", ifnet_state_dict_from_jax(iv, 2)),
                       ("denoise", unet_sp_state_dict_from_jax(dv)),
                       ("fusion", unet_sp_state_dict_from_jax(fv))):
        getattr(model, branch).load_state_dict(sd, strict=True)
    model.double()
    _, metrics = step(TrainState(model, opt),
                      _port_batch(shared["batch"], torch.float64))
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss),
                               rtol=1e-5, atol=0)
    _leaves_close(load_torch_ifnet(_grads(model.vfi), n_frames=2)["params"],
                  want_grad["vfi"], 1e-4, floor=1e-12)
    for branch in ("denoise", "fusion"):
        net = getattr(model, branch)
        _leaves_close(load_torch_unet_sp(_grads(net))["params"],
                      want_grad[branch], 1e-4, floor=1e-12)
        _assert_bn_stats(net, want_stats[branch])
    assert [g["lr"] for g in opt.inner.param_groups] == [
        float(np.float32(1e-4 * w)) for w in (1e-20, 1e-6, 1.0)]
