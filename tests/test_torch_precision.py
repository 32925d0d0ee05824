"""The port's matmul-precision policy (``sstem_tpu_torch/config.py``)
against the JAX package's (``sstem_tpu/config.py``).

Every port entry point applies the policy first: a fresh process, whose
torch flags start with cuDNN TF32 on, computes float32 at ``"highest"``
unless its caller set a lower policy. On the CPU the JAX side computes
float32 whatever the precision and TF32 does not exist, so the layers are
compared with JAX at ``"highest"`` only; under ``"default"`` they are held
to their own definition (one bf16 pass, float32 out, BatchNorm in float32).
Each test sets back the flags and the policy it changed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sstem_tpu.models.layers import Conv2dTorch, ConvTranspose2dTorch
from sstem_tpu_torch import config, losses
from sstem_tpu_torch.cli import (
    infer_interp, test_sp_interp, train_fusion, train_interp,
    train_sp_correction, train_sp_fusion, train_sp_interp, train_unfolding,
)
from sstem_tpu_torch.infer.pipeline import SFFPipeline, SPPipeline
from sstem_tpu_torch.infer.tiles import infer_full, infer_tiled
from sstem_tpu_torch.models import IFNet, layers


def tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture(autouse=True)
def restore_policy():
    saved = config.matmul_precision(), tf32_flags(), config.compute_dtype()
    yield
    config.set_matmul_precision(saved[0])
    config.COMPUTE_DTYPE = saved[2]
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        saved[1]


def torch_defaults():
    """The flags of a fresh process that turned TF32 on (cuDNN's is on in
    torch's own defaults)."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True


def sp_pipeline():
    with layers.skip_init():
        vfi = IFNet(5, n_frames=2)
    return SPPipeline(vfi, device="cpu")


def identity(x):
    return x


ENTRY_POINTS = {
    "SFFPipeline": lambda tmp: SFFPipeline(None, None, None, device="cpu"),
    "SPPipeline": lambda tmp: sp_pipeline(),
    "infer_full": lambda tmp: infer_full(identity, torch.zeros(1, 40, 40, 1)),
    "infer_tiled": lambda tmp: infer_tiled(identity, torch.zeros(40, 40, 1),
                                           tile=32, halo=4),
}
# a CLI's argument path: main() as far as its (missing) config file
CLIS = {
    "train_interp": (train_interp, "-c"),
    "train_unfolding": (train_unfolding, "-c"),
    "train_fusion": (train_fusion, "-c"),
    "train_sp_interp": (train_sp_interp, "-opt"),
    "train_sp_correction": (train_sp_correction, "-opt"),
    "train_sp_fusion": (train_sp_fusion, "-opt"),
    "infer_interp": (infer_interp, "-c"),
}


def cli_argument_path(name, tmp_path):
    module, flag = CLIS[name]
    with pytest.raises(FileNotFoundError):
        module.main([flag, str(tmp_path / "missing.yaml"), "--device", "cpu"])


@pytest.mark.parametrize("entry", list(ENTRY_POINTS) + ["train_interp",
                                                        "infer_interp",
                                                        "test_sp_interp"])
def test_entry_point_turns_tf32_off(entry, tmp_path):
    torch_defaults()
    if entry == "test_sp_interp":
        with pytest.raises(FileNotFoundError):
            test_sp_interp.main(["-mp", str(tmp_path / "missing.ckpt"),
                                 "-dp", str(tmp_path), "-im1", "a.png",
                                 "-im2", "b.png", "-sp", str(tmp_path),
                                 "--device", "cpu"])
    elif entry in CLIS:
        cli_argument_path(entry, tmp_path)
    else:
        ENTRY_POINTS[entry](tmp_path)
    assert config.matmul_precision() == "highest"
    assert tf32_flags() == (False, False)


@pytest.mark.parametrize("trainer", [n for n in CLIS if n.startswith("train")])
def test_trainer_keeps_the_callers_policy(trainer, tmp_path):
    config.set_matmul_precision("default")
    config.set_compute_dtype("bfloat16")
    cli_argument_path(trainer, tmp_path)
    assert config.matmul_precision() == "default"
    assert config.compute_dtype() is torch.bfloat16
    assert config.BF16_PASS
    assert torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "medium"


def test_policy_names():
    assert config.matmul_precision() == "highest"
    assert not config.BF16_PASS
    with pytest.raises(KeyError):
        config.set_matmul_precision("fast")
    assert config.matmul_precision() == "highest"
    for name, level, tf32 in (("high", "high", True),
                              ("default", "medium", True),
                              ("highest", "highest", False)):
        config.set_matmul_precision(name)
        assert config.matmul_precision() == name
        assert torch.get_float32_matmul_precision() == level
        assert tf32_flags() == (tf32, tf32)
    config.set_matmul_precision("default")
    config.disable_tf32()
    assert config.matmul_precision() == "highest"
    assert tf32_flags() == (False, False)


def seeded_layers(seed=0, cin=5, cout=7):
    g = torch.Generator().manual_seed(seed)
    conv = layers.materialize(layers.conv3x3(cin, cout), g,
                              layers.torch_default_)
    deconv = layers.materialize(layers.deconv2x(cin, cout), g,
                                layers.torch_default_)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, cin, 12, 10)).astype(np.float32))
    return conv, deconv, x


def test_layers_match_jax_at_highest():
    conv, deconv, x = seeded_layers()
    x_nhwc = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
    # torch (out, in, kh, kw) -> flax HWIO; ConvTranspose2dTorch stores
    # torch's (in, out, kh, kw) as (kh, kw, out, in)
    kernel = jnp.asarray(conv.weight.detach().permute(2, 3, 1, 0).numpy())
    want = Conv2dTorch(conv.out_channels).apply(
        {"params": {"Conv_0": {"kernel": kernel,
                               "bias": jnp.asarray(conv.bias.detach())}}},
        x_nhwc)
    dkernel = jnp.asarray(deconv.weight.detach().permute(2, 3, 1, 0).numpy())
    dwant = ConvTranspose2dTorch(deconv.out_channels).apply(
        {"params": {"kernel": dkernel,
                    "bias": jnp.asarray(deconv.bias.detach())}}, x_nhwc)
    with torch.no_grad():
        for got, ref in ((conv(x), want), (deconv(x), dwant)):
            err = np.abs(got.permute(0, 2, 3, 1).numpy()
                         - np.asarray(jax.device_get(ref))).max()
            assert err <= 5e-4, err


def test_default_is_one_bf16_pass():
    conv, deconv, x = seeded_layers(1)
    bf = torch.bfloat16
    with torch.no_grad():
        highest = conv(x), deconv(x)
        want = (F.conv2d(x.to(bf), conv.weight.to(bf), padding=1).float()
                + conv.bias[None, :, None, None],
                F.conv_transpose2d(x.to(bf), deconv.weight.to(bf), stride=2,
                                   padding=1, output_padding=1).float()
                + deconv.bias[None, :, None, None])
        config.set_matmul_precision("default")
        got = conv(x), deconv(x)
    for g, w, h in zip(got, want, highest):
        assert g.dtype == torch.float32
        assert torch.equal(g, w)
        assert (g - h).abs().max() > 1e-3
    # a channels-last input still gives an NCHW-contiguous float32 result,
    # as the float32 conv does (the sepconv kernels take contiguous maps)
    with torch.no_grad():
        cl = x.contiguous(memory_format=torch.channels_last)
        for layer, w in zip((conv, deconv), want):
            y = layer(cl)
            assert y.is_contiguous() and torch.equal(y, w)
    # the SSIM window conv: one bf16 pass too
    img = torch.rand(1, 2, 16, 16, generator=torch.Generator().manual_seed(2))
    blur = losses._grouped_blur(img, 11, 1.5)
    win = torch.from_numpy(losses._gauss_window(11, 1.5)).expand(2, 1, 11, 11)
    assert torch.equal(blur, F.conv2d(img.to(bf), win.to(bf), padding=5,
                                      groups=2).float())
    # inside autograd: the gradients come back float32
    xg = x.clone().requires_grad_(True)
    conv(xg).square().sum().backward()
    assert xg.grad.dtype == conv.weight.grad.dtype == torch.float32


def test_batchnorm_stays_float32_under_default():
    conv, _, x = seeded_layers(3)
    bn = layers.materialize(layers.batchnorm(conv.out_channels),
                            torch.Generator().manual_seed(3),
                            layers.torch_default_, bn_weight_std=0.1)
    config.set_matmul_precision("default")
    with torch.no_grad():
        y = conv(x)
        for train in (True, False):
            bn.train(train)
            ref = F.batch_norm(y, bn.running_mean.clone(),
                               bn.running_var.clone(), bn.weight, bn.bias,
                               training=train, momentum=0.0, eps=bn.eps)
            got = bn(y)
            assert got.dtype == torch.float32
            assert torch.equal(got, ref)
            # not a bf16 rounding of it
            assert not torch.equal(got, ref.to(torch.bfloat16).float())
