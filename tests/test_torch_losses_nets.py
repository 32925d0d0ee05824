"""The port's remaining losses, metrics and nets (sstem_tpu_torch: losses
ms_ssim, gan_loss, g_loss, d_loss, vgg_feature_loss, perceptual_loss;
metrics calculate_psnr, calculate_ssim, psnr, ssim; models/vgg;
models/discriminators; compat/weights.discriminator_state_dict_from_jax;
cli/_sff's perceptual criterion and train_interp's perceptual step) vs the
JAX package.

Inputs and weights are made with numpy from seeds (the VGG19 as one seeded
state dict file in torchvision's layout, which both packages load) and go
to both sides in float32. Bounds: 5e-4 absolute on values, gradients
within 1e-4 of their tensor's max |gradient| (ROADMAP "Tolerances"); the
float64 SP metrics exactly. Each JAX program is compiled once, in a
module-scoped fixture.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

import jax
import jax.numpy as jnp

from sstem_tpu import losses as jax_losses
from sstem_tpu import metrics as jax_metrics
from sstem_tpu.cli import _sff as jax_sff
from sstem_tpu.cli.train_interp import build as jax_build
from sstem_tpu.compat.config import load_sff_config as jax_load_sff_config
from sstem_tpu.compat.torch_ckpt import load_torch_ifnet
from sstem_tpu.models import discriminators as jax_disc
from sstem_tpu.models.vgg import VGG19Features as JaxVGG
from sstem_tpu.models.vgg import load_torch_vgg19_features as jax_load_vgg
from sstem_tpu.train.trainer import TrainState as JaxTrainState
from sstem_tpu_torch import losses, metrics
from sstem_tpu_torch.cli import _sff, train_interp
from sstem_tpu_torch.compat.config import load_sff_config
from sstem_tpu_torch.compat.weights import (
    discriminator_state_dict_from_jax, ifnet_state_dict_from_jax,
)
from sstem_tpu_torch.models import discriminators
from sstem_tpu_torch.models.layers import skip_init
from sstem_tpu_torch.models.vgg import (
    VGG19Features, load_torch_vgg19_features, seeded_torchvision_vgg19,
)
from sstem_tpu_torch.train.trainer import TrainState

from _torch_port import ifnet_variables

torch.set_num_threads(1)

VALUE_ATOL = 5e-4
GRAD_REL = 1e-4
K = 5  # the interp step's kernel size, as tests/test_torch_train.py


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _grad_close(got, want, rel=GRAD_REL, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=name)


def _decisions(modules, run):
    """The side of every ReLU input and the argmax of every 2x2 max pool of
    ``modules`` in one call of ``run()``."""
    seen = []

    def relu(m, i, o):
        seen.append(i[0].detach() > 0)

    def pool(m, i, o):
        seen.append(F.max_pool2d(i[0].detach(), 2, 2, return_indices=True)[1])

    hooks = [m.register_forward_hook(relu if isinstance(m, torch.nn.ReLU)
                                     else pool)
             for mod in modules for m in mod.modules()
             if isinstance(m, (torch.nn.ReLU, torch.nn.MaxPool2d))]
    try:
        with torch.no_grad():
            run()
    finally:
        for h in hooks:
            h.remove()
    return seen


def _kinks(modules, run, run64):
    """How many ReLU inputs and max-pool argmaxes of the port's float32
    forward (``run``) take another side than its float64 forward
    (``run64``, on float64 copies of ``modules``). A ReLU input within
    float32 rounding of 0 may take either side in a sound float32 forward
    (the CPU's oneDNN convolutions sum in their own order), and then moves
    a gradient by percents of its tensor's max (ROADMAP section 3, "ReLU
    kinks"): the gradient bounds below hold where there is none."""
    a = _decisions(modules[0], run)
    b = _decisions(modules[1], run64)
    assert len(a) == len(b) > 0
    return sum(int((x != y).sum()) for x, y in zip(a, b))


def _first_without_kinks(draws, modules, run, run64):
    """The first of the seeded ``draws`` on which the port's float32 and
    float64 forwards take the same side everywhere (``_kinks``), as
    chip_smoke.py's phase 23 picks its batch."""
    for draw in draws:
        if _kinks(modules, lambda: run(draw), lambda: run64(draw)) == 0:
            return draw
    raise AssertionError("no seeded draw keeps every ReLU side in float32")


@pytest.fixture(scope="module")
def vgg_path(tmp_path_factory):
    """One seeded VGG19 state dict file in torchvision's layout (all 16
    feature convs)."""
    path = str(tmp_path_factory.mktemp("vgg") / "vgg19.pth")
    torch.save(seeded_torchvision_vgg19(seed=7), path)
    return path


@pytest.fixture(scope="module")
def jax_vgg(vgg_path):
    """JAX's VGG19 on the file: the taps of one input and the perceptual
    loss and its gradient with respect to the prediction (non-default
    weights and an L2 pixel term), in one compiled program. The prediction
    is the first of three seeded draws without a float32 kink in the
    port's VGG (``_first_without_kinks``)."""
    variables = jax_load_vgg(vgg_path)
    model = JaxVGG()
    x = np.random.default_rng(61).random((1, 32, 32, 3), dtype=np.float32)
    draws = []
    for seed in (62, 63, 64):
        rng = np.random.default_rng(seed)
        pred = rng.random((2, 32, 32, 1), dtype=np.float32)
        draws.append((pred, np.clip(pred + rng.normal(0, 0.1, pred.shape),
                                    0, 1).astype(np.float32)))
    vgg = _sff.load_vgg_apply(vgg_path, "cpu")
    vgg64 = copy.deepcopy(vgg).double()
    pred, target = _first_without_kinks(
        draws, ([vgg], [vgg64]),
        lambda d: [vgg(_nchw(a).repeat(1, 3, 1, 1)) for a in d],
        lambda d: [vgg64(_nchw(a).double().repeat(1, 3, 1, 1)) for a in d])

    def run(x, pred, target):
        def loss(p):
            return jax_losses.perceptual_loss(
                lambda z: model.apply(variables, z), p, target,
                vgg_weight=0.5, com_weight=2.0, combine="L2")

        value, grad = jax.value_and_grad(loss)(pred)
        return model.apply(variables, x), value, grad

    taps, value, grad = jax.jit(run)(x, pred, target)
    return dict(x=x, pred=pred, target=target, taps=taps, value=value,
                grad=grad)


def test_vgg19_features_match_jax(vgg_path, jax_vgg):
    """Both packages load the same torchvision-layout file (the three convs
    past conv5_1 left out): the five taps within 5e-4, the port's module
    keys torchvision's."""
    sd = load_torch_vgg19_features(vgg_path)
    assert len(sd) == 26 and "features.30.weight" not in sd
    with skip_init():
        vgg = VGG19Features()
    assert sorted(vgg.state_dict()) == sorted(sd)
    vgg.load_state_dict(sd, strict=True)
    with torch.no_grad():
        taps = vgg(_nchw(jax_vgg["x"]))
    assert list(taps) == list(losses.VGG_TAPS)
    for name, want in jax_vgg["taps"].items():
        np.testing.assert_allclose(_nhwc(taps[name]), np.asarray(want),
                                   rtol=0, atol=VALUE_ATOL, err_msg=name)


def test_perceptual_loss_and_grad_match_jax(vgg_path, jax_vgg):
    """The perceptual loss at 2 x 1 x 32^2 (vgg_weight 0.5, com_weight 2,
    L2 pixel term) within 5e-4, and its gradient with respect to the
    prediction within 1e-4 of its max; the frozen VGG takes no gradient."""
    vgg = _sff.load_vgg_apply(vgg_path, "cpu")
    pred = _nchw(jax_vgg["pred"]).requires_grad_(True)
    loss = losses.perceptual_loss(vgg, pred, _nchw(jax_vgg["target"]),
                                  vgg_weight=0.5, com_weight=2.0,
                                  combine="L2")
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jax_vgg["value"]), rtol=0,
                               atol=VALUE_ATOL)
    _grad_close(_nhwc(pred.grad), jax_vgg["grad"])
    assert not vgg.training
    assert all(p.grad is None and not p.requires_grad for p in vgg.parameters())


@pytest.mark.parametrize("mode", [1, 2])
def test_vgg_feature_loss_matches_jax(mode):
    """Both modes (L1, L2) with the default and with given tap weights."""
    rng = np.random.default_rng(62 + mode)
    shapes = [(2, 8 >> i, 8 >> i, 4) for i in range(5)]
    f1, f2 = ({tap: rng.normal(0, 1, s).astype(np.float32)
               for tap, s in zip(losses.VGG_TAPS, shapes)} for _ in range(2))
    for weights in ((1.0,) * 5, (0.5, 1.0, 2.0, 0.25, 3.0)):
        got = losses.vgg_feature_loss(
            {k: _nchw(v) for k, v in f1.items()},
            {k: _nchw(v) for k, v in f2.items()}, mode, weights)
        want = jax_losses.vgg_feature_loss(
            {k: jnp.asarray(v) for k, v in f1.items()},
            {k: jnp.asarray(v) for k, v in f2.items()}, mode, weights)
        np.testing.assert_allclose(float(got), float(want), rtol=0,
                                   atol=VALUE_ATOL)


@pytest.mark.parametrize("max_val", [255.0, 1.0])
def test_ms_ssim_matches_jax(max_val):
    """MS-SSIM at 2 x 1 x 64^2 (windows 11, 11, 11, 8, 4 down the levels)
    and at an odd 2 x 1 x 67 x 70 (the pool floors), within 5e-4."""
    rng = np.random.default_rng(64)
    for h, w in ((64, 64), (67, 70)):
        a = rng.random((2, h, w, 1)).astype(np.float32) * max_val
        b = np.clip(a + rng.normal(0, 0.1 * max_val, a.shape), 0,
                    max_val).astype(np.float32)
        kw = {} if max_val == 255.0 else {"max_val": max_val}
        got = float(losses.ms_ssim(_nchw(a), _nchw(b), **kw))
        want = float(jax_losses.ms_ssim(jnp.asarray(a), jnp.asarray(b), **kw))
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=0, atol=VALUE_ATOL)


@pytest.mark.parametrize("mode", ["lsgan", "vanilla", "wgangp"])
def test_gan_losses_match_jax(mode):
    """gan_loss (real and fake targets), g_loss and d_loss within 5e-4;
    an unknown mode is refused on both sides."""
    rng = np.random.default_rng(65)
    fake = rng.normal(0, 2, (2, 1, 6, 6)).astype(np.float32)
    real = rng.normal(1, 2, (2, 1, 6, 6)).astype(np.float32)
    tf, tr = torch.from_numpy(fake), torch.from_numpy(real)
    jf, jr = jnp.asarray(fake), jnp.asarray(real)
    pairs = [(losses.gan_loss(tf, t, mode), jax_losses.gan_loss(jf, t, mode))
             for t in (True, False)]
    pairs.append((losses.g_loss(tf, mode), jax_losses.g_loss(jf, mode)))
    pairs.append((losses.d_loss(tf, tr, mode), jax_losses.d_loss(jf, jr, mode)))
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=0,
                                   atol=VALUE_ATOL)
    with pytest.raises(NotImplementedError):
        losses.gan_loss(tf, True, "hinge")


def test_sp_metrics_match_jax_exactly():
    """calculate_psnr and calculate_ssim (2-D, 3-channel and 1-channel
    images, and identical images) equal JAX's float64 values exactly."""
    rng = np.random.default_rng(66)
    a = rng.integers(0, 256, (40, 44, 3), dtype=np.uint8)
    b = np.clip(a + rng.normal(0, 8, a.shape), 0, 255).astype(np.uint8)
    for x, y in ((a[..., 0], b[..., 0]), (a, b), (a[..., :1], b[..., :1]),
                 (a, a)):
        assert metrics.calculate_psnr(x, y) == jax_metrics.calculate_psnr(x, y)
        assert metrics.calculate_ssim(x, y) == jax_metrics.calculate_ssim(x, y)
    with pytest.raises(ValueError):
        metrics.calculate_ssim(a, b[:-1])


def test_device_metrics_match_jax():
    """``psnr`` (also at an MSE of 0, clamped at 1e-12) and ``ssim``
    (2-D and batched, centred before the variance terms) within 5e-4; the
    SSIM of bright, nearly flat images (where E[x^2] - mu^2 would cancel in
    float32) too."""
    rng = np.random.default_rng(67)
    a = rng.random((2, 40, 48)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    flat = (230 + rng.random((2, 40, 48)) * 2).astype(np.float32)
    flat2 = flat + rng.normal(0, 0.5, flat.shape).astype(np.float32)
    cases = [
        (metrics.psnr(torch.from_numpy(a), torch.from_numpy(b)),
         jax_metrics.psnr(jnp.asarray(a), jnp.asarray(b))),
        (metrics.psnr(torch.from_numpy(a), torch.from_numpy(a)),
         jax_metrics.psnr(jnp.asarray(a), jnp.asarray(a))),
        (metrics.psnr(torch.from_numpy(a * 255), torch.from_numpy(b * 255), 255.0),
         jax_metrics.psnr(jnp.asarray(a * 255), jnp.asarray(b * 255), 255.0)),
        (metrics.ssim(torch.from_numpy(a[0]), torch.from_numpy(b[0]), 1.0),
         jax_metrics.ssim(jnp.asarray(a[0]), jnp.asarray(b[0]), 1.0)),
        (metrics.ssim(torch.from_numpy(flat), torch.from_numpy(flat2)),
         jax_metrics.ssim(jnp.asarray(flat), jnp.asarray(flat2))),
    ]
    assert float(cases[1][0]) == pytest.approx(120.0)
    for got, want in cases:
        np.testing.assert_allclose(float(got), float(want), rtol=0,
                                   atol=VALUE_ATOL)
    want = metrics.compute_ssim(np.rint(flat[0]), np.rint(flat2[0]))
    got = metrics.ssim(torch.from_numpy(np.rint(flat[0])),
                       torch.from_numpy(np.rint(flat2[0])))
    np.testing.assert_allclose(float(got), want, rtol=0, atol=VALUE_ATOL)


# ---------------------------------------------------------------------------
# the discriminators and the replay buffer
# ---------------------------------------------------------------------------

DISCS = ("Discriminator", "Discriminator2", "Discriminator3",
         "NLayerDiscriminator", "PixelDiscriminator")


def _disc_variables(model, x, seed):
    """The variables of ``model.init`` filled from ``seed``: conv kernels
    He-uniform, biases U(+-0.05); BN scale 1 + N(0, 0.1), bias and mean
    N(0, 0.1), var U(0.5, 1.5)."""
    tree = jax.eval_shape(lambda k: model.init(k, x), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, s = path[-1].key, leaf.shape
        if name == "kernel":
            a = rng.uniform(-1, 1, s) * np.sqrt(6.0 / (s[0] * s[1] * s[2]))
        elif name == "scale":
            a = 1 + rng.normal(0, 0.1, s)
        elif name == "mean" or (name == "bias" and path[-2].key.startswith("bn")):
            a = rng.normal(0, 0.1, s)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, s)
        else:
            a = rng.uniform(-0.05, 0.05, s)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


@pytest.fixture(scope="module")
def jax_discs():
    """Each JAX discriminator at 2 x 32^2 x 1 on seeded variables: its
    output in train mode (batch statistics, and the running statistics it
    leaves) and, for the BN heads, in eval mode."""
    x = np.random.default_rng(68).normal(0, 1, (2, 32, 32, 1)).astype(np.float32)
    out = {}
    for i, kind in enumerate(DISCS):
        model = getattr(jax_disc, kind)()
        v = _disc_variables(model, jnp.asarray(x), 70 + i)
        if "batch_stats" in v:
            y, upd = jax.jit(lambda v, x: model.apply(
                v, x, train=True, mutable=["batch_stats"]))(v, x)
            y_eval = jax.jit(lambda v, x: model.apply(v, x, train=False))(v, x)
            out[kind] = (v, y, upd["batch_stats"], y_eval)
        else:
            out[kind] = (v, jax.jit(model.apply)(v, x), None, None)
    return x, out


@pytest.mark.parametrize("kind", DISCS)
def test_discriminators_match_jax(kind, jax_discs):
    """Each head on the same weights and input: outputs within 5e-4 (train
    mode, and eval mode for the BN heads); after the train-mode call the
    running means within 5e-4 of flax's, and the running variances within
    5e-4 of flax's converted from its biased update to the unbiased one
    that PyTorch (and the reference) keep: flax leaves 0.9 var0 + 0.1 v
    with v the biased batch variance, PyTorch 0.9 var0 + 0.1 v n / (n - 1),
    n the BN input's N*H*W."""
    x, out = jax_discs
    variables, want, want_stats, want_eval = out[kind]
    with skip_init():
        port = getattr(discriminators, kind)()
    port.load_state_dict(discriminator_state_dict_from_jax(variables, kind),
                         strict=True)
    seen = {}
    hooks = [m.register_forward_hook(
        lambda m, i, o, name=name: seen.__setitem__(name, i[0].shape))
        for name, m in port.named_modules()
        if isinstance(m, torch.nn.BatchNorm2d)]
    port.train()
    with torch.no_grad():
        got = port(_nchw(x))
    for h in hooks:
        h.remove()
    want = np.asarray(want)
    got = got.numpy() if got.dim() == 2 else _nhwc(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=VALUE_ATOL)
    if want_stats is None:
        assert not seen
        return
    bn_names = ({"net.3": "bn1"} if kind == "PixelDiscriminator" else
                {"model.3": "bn1", "model.6": "bn2", "model.9": "bn3"})
    assert sorted(seen) == sorted(bn_names)
    for prefix, name in bn_names.items():
        shape = seen[prefix]
        n = shape[0] * shape[2] * shape[3]
        var0 = np.asarray(variables["batch_stats"][name]["var"])
        flax_var = np.asarray(want_stats[name]["var"])
        unbiased = 0.9 * var0 + (flax_var - 0.9 * var0) * n / (n - 1)
        sd = port.state_dict()
        np.testing.assert_allclose(sd[f"{prefix}.running_mean"].numpy(),
                                   np.asarray(want_stats[name]["mean"]),
                                   rtol=0, atol=VALUE_ATOL)
        np.testing.assert_allclose(sd[f"{prefix}.running_var"].numpy(),
                                   unbiased, rtol=0, atol=VALUE_ATOL)
        # the conversion is not a no-op at these sizes
        assert np.abs(unbiased - flax_var).max() > 1e-4 / n
    port.load_state_dict(discriminator_state_dict_from_jax(variables, kind))
    port.eval()
    with torch.no_grad():
        np.testing.assert_allclose(_nhwc(port(_nchw(x))), np.asarray(want_eval),
                                   rtol=0, atol=VALUE_ATOL)


def test_replay_buffer_matches_jax():
    """The same pushes give the same pops, element for element, through the
    pool's fill and its random swaps."""
    rng = np.random.default_rng(69)
    ours = discriminators.ReplayBuffer(max_size=4, seed=3)
    theirs = jax_disc.ReplayBuffer(max_size=4, seed=3)
    swapped = 0
    for _ in range(8):
        batch = rng.normal(0, 1, (3, 1, 4, 4)).astype(np.float32)
        got = ours.push_and_pop(torch.from_numpy(batch)).numpy()
        want = theirs.push_and_pop(batch)
        np.testing.assert_array_equal(got, want)
        swapped += int((got != batch).any(axis=(1, 2, 3)).sum())
    assert swapped > 0
    with pytest.raises(ValueError):
        discriminators.ReplayBuffer(max_size=0)


# ---------------------------------------------------------------------------
# the perceptual criterion and train_interp's perceptual step
# ---------------------------------------------------------------------------

def test_make_pixel_criterion_perceptual(vgg_path, jax_vgg):
    """Without VGG weights the perceptual loss is refused as in JAX (the
    same assertion message); with them it is perceptual_loss at the given
    weights and pixel term."""
    with pytest.raises(AssertionError) as ours:
        _sff.make_pixel_criterion("perceptual")
    with pytest.raises(AssertionError) as theirs:
        jax_sff.make_pixel_criterion("perceptual")
    assert str(ours.value) == str(theirs.value)
    crit = _sff.make_pixel_criterion(
        "perceptual", _sff.load_vgg_apply(vgg_path, "cpu"), vgg_weight=0.5,
        com_weight=2.0, loss_combine="L2")
    with torch.no_grad():
        got = crit(_nchw(jax_vgg["pred"]), _nchw(jax_vgg["target"]))
    np.testing.assert_allclose(float(got), float(jax_vgg["value"]), rtol=0,
                               atol=VALUE_ATOL)


def _interp_cfg(tmp_path, data):
    cfg = {"NAME": "interp_perceptual",
           "TRAIN": {"loss": "perceptual", "kernel_size": K,
                     "vgg_weight": 0.5, "com_weight": 2.0,
                     "loss_combine": "L2", "base_lr": 1e-3, "end_lr": 1e-3,
                     "weight_decay": 1e-4, "batch_size": 2},
           "DATA": {"folder_name": data}}
    path = str(tmp_path / "interp.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def test_train_interp_perceptual_step_matches_jax(vgg_path, tmp_path):
    """One step of the port's ``train_interp.build(cfg, vgg_weights=...)``
    against the JAX ``build`` (IFNet K=5, 2 x 32^2, the perceptual loss at
    vgg_weight 0.5, com_weight 2, L2 pixel term, AdamW): the loss within
    5e-4 and every IFNet gradient within 1e-4 of its tensor's max (JAX's
    from Adam's first moment, g = mu / (1 - b1); the port's is the
    gradient its optimizer took, one update). The batch is the first of
    three seeded ones without a float32 kink in the port's IFNet and VGG
    (``_first_without_kinks``). The VGG takes no gradient and is in no
    optimizer group and no checkpoint."""
    path = _interp_cfg(tmp_path, str(tmp_path))
    iv = ifnet_variables(K, seed=80)
    with skip_init():
        model, popt, step, _, _, crit = train_interp.build(
            load_sff_config(path), "cpu", vgg_weights=vgg_path)
    model.load_state_dict(ifnet_state_dict_from_jax(iv), strict=True)
    vgg = crit.args[0]
    model64, vgg64 = copy.deepcopy(model).double(), copy.deepcopy(vgg).double()
    draws = []
    for seed in (81, 82, 83):
        rng = np.random.default_rng(seed)
        draws.append((rng.random((2, 32, 32, 6), dtype=np.float32),
                      rng.random((2, 32, 32, 1), dtype=np.float32)))
    x, y = _first_without_kinks(
        draws, ([model, vgg], [model64, vgg64]),
        lambda d: vgg(model(_nchw(d[0])).repeat(1, 3, 1, 1)),
        lambda d: vgg64(model64(_nchw(d[0]).double()).repeat(1, 3, 1, 1)))

    _, opt, jstep, _, _, _ = jax_build(jax_load_sff_config(path), vgg_path,
                                       data_parallel=False)
    jstate, jmetrics = jstep(JaxTrainState.create(iv["params"], opt),
                             (jnp.asarray(x), jnp.asarray(y)))
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
        if hasattr(s, "mu")]

    _, metrics_ = step(TrainState(model, popt), (_nchw(x), _nchw(y)))
    np.testing.assert_allclose(float(metrics_["loss"]),
                               float(jmetrics["loss"]), rtol=0,
                               atol=VALUE_ATOL)
    assert popt.count == 1
    got = load_torch_ifnet({k: p.grad for k, p in model.named_parameters()})
    want_grad = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, adam.mu)
    leaves = jax.tree_util.tree_leaves_with_path(want_grad)
    assert len(leaves) == len(list(model.parameters()))
    for path_, want in leaves:
        have = got["params"]
        for key in path_:
            have = have[key.key]
        _grad_close(have, want, name=jax.tree_util.keystr(path_))

    assert isinstance(vgg, VGG19Features) and not vgg.training
    assert all(p.grad is None and not p.requires_grad for p in vgg.parameters())
    in_opt = {id(p) for g in popt.inner.param_groups for p in g["params"]}
    assert in_opt == {id(p) for p in model.parameters()}
    assert not any(k.startswith("features.") for k in model.state_dict())
