"""The port's fused-conv serving path (sstem_tpu_torch/kernels/{conv3x3,
deconv,pool,head_tail}.py, sstem_tpu_torch/models/serving.py) vs the JAX
package.

Each kernel module's CPU path (its plain version) is held against the JAX
Pallas kernel in interpret mode, one call per variant at a small legal shape,
on the same bf16 values. Bounds:

  * pool: exact (max is exact; avg sums in the JAX kernel's order);
  * conv3x3 and deconv: one bf16 ulp of the value, plus 2^-14 of the
    tensor's max |value|: both sides round once to bf16 from f32 sums that
    differ only in order, and where a sum cancels to near zero that order
    noise exceeds an ulp of the small result;
  * head tail: 2e-2 of the max |value|, tests/test_head_tail.py's bound (the
    JAX kernel and F.interpolate may round an upsampled value to different
    bf16 neighbours).

The serving forwards are held to the port's own eval modules in bf16 (which
tests/test_torch_models.py holds to flax) on the numpy weights of
tests/_torch_port.py: NRMSE below 0.05 of the output's std, the bound
tests/test_serving.py sets between the JAX serving forwards and flax.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from sstem_tpu.kernels.conv3x3 import (
    build_packed_weights,
    conv3x3_packed,
    pack_nhwc,
    unpack_nhwc,
)
from sstem_tpu.kernels.deconv import build_packed_deconv_weights, deconv2x_packed
from sstem_tpu.kernels.head_tail import dephase_transpose, head_tail_fused
from sstem_tpu.kernels.pool import pool2x_packed
from sstem_tpu_torch.config import PARITY_DTYPE
from sstem_tpu_torch.infer.pipeline import SFFPipeline
from sstem_tpu_torch.kernels import (
    conv3x3_fused,
    deconv2x_fused,
    fold_affine,
    head_tail,
    pool2x,
)
from sstem_tpu_torch.models.layers import set_compute_dtype
from sstem_tpu_torch.models.serving import (
    fold_gray_pair_conv,
    fusionnet_serve,
    ifnet_serve,
    unet_sff_serve,
)

from _torch_port import port_sff_models, sff_variables

torch.set_num_threads(1)

K = 5
BF = torch.bfloat16


def _bf16(a):
    """numpy float32 -> (the same values rounded to bf16 as float32 numpy,
    as a bf16 torch tensor)."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF)
    return t.float().numpy(), t


def _ulp(x):
    """One bf16 unit in the last place of |x| (8 significant bits)."""
    m = np.maximum(np.abs(x), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(m)) - 7)


def _assert_bf16_close(got, want):
    err = np.abs(got - want)
    tol = _ulp(np.maximum(np.abs(got), np.abs(want))) + 2.0 ** -14 * np.abs(
        want).max()
    assert (err <= tol).all(), (err.max(), (err / tol).max())


def _affine(rng, c):
    scale = (rng.random(c) + 0.5).astype(np.float32)
    shift = (rng.normal(0, 0.1, c)).astype(np.float32)
    return scale, shift


@pytest.mark.parametrize("c,act,res", [(32, "relu", "post"), (64, "leaky", "pre"),
                                       (64, None, None)])
def test_conv3x3_matches_pallas(c, act, res):
    rng = np.random.default_rng(c + len(str(act)) + len(str(res)))
    n, h, w = 1, 16, 16
    x, xt = _bf16(rng.normal(size=(n, h, w, c)))
    wk, wt = _bf16(rng.normal(size=(3, 3, c, c)) * (2.0 / (9 * c)) ** 0.5)
    scale, shift = _affine(rng, c)
    r, rt = _bf16(rng.normal(size=(n, h, w, c))) if res else (None, None)
    got = conv3x3_fused(xt, wt, torch.from_numpy(scale), torch.from_numpy(shift),
                        act, rt, res == "pre")
    p = 128 // c
    yq = conv3x3_packed(
        pack_nhwc(jnp.asarray(x, jnp.bfloat16)),
        build_packed_weights(jnp.asarray(wk, jnp.bfloat16), p),
        jnp.tile(scale, p), jnp.tile(shift, p), act, wq=w // p,
        residual=None if res is None else pack_nhwc(jnp.asarray(r, jnp.bfloat16)),
        residual_pre_affine=res == "pre", interpret=True)
    want = np.asarray(unpack_nhwc(yq, c, w), np.float32)
    assert got.dtype == BF and got.shape == want.shape
    _assert_bf16_close(got.float().numpy(), want)


@pytest.mark.parametrize("cin,act,mode", [(64, "relu", "post_act_half"),
                                          (128, "leaky", "post_affine")])
def test_deconv2x_matches_pallas(cin, act, mode):
    rng = np.random.default_rng(cin)
    cout = cin // 2
    n, h, w = 1, 8, 16
    x, xt = _bf16(rng.normal(size=(n, h, w, cin)))
    # the port's (3, 3, Cin, Cout) is JAX's (kh, kw, Cout, Cin) transposed
    wk, wt = _bf16(rng.normal(size=(3, 3, cin, cout)) * (1.0 / cin) ** 0.5)
    scale, shift = _affine(rng, cout)
    r, rt = _bf16(rng.normal(size=(n, 2 * h, 2 * w, cout)))
    got = deconv2x_fused(xt, wt, torch.from_numpy(scale),
                         torch.from_numpy(shift), act, rt, mode)
    p_in, p_out = 128 // cin, 128 // cout
    yq = deconv2x_packed(
        pack_nhwc(jnp.asarray(x, jnp.bfloat16)),
        build_packed_deconv_weights(
            jnp.asarray(wk.transpose(0, 1, 3, 2), jnp.bfloat16), cin),
        jnp.tile(scale, p_out), jnp.tile(shift, p_out), act, wq=w // p_in,
        residual=pack_nhwc(jnp.asarray(r, jnp.bfloat16)), res_mode=mode,
        interpret=True)
    want = np.asarray(unpack_nhwc(yq, cout, 2 * w), np.float32)
    assert got.shape == want.shape
    _assert_bf16_close(got.float().numpy(), want)


@pytest.mark.parametrize("mode", ["max", "avg"])
def test_pool2x_matches_pallas(mode):
    rng = np.random.default_rng(3)
    n, h, w, c = 1, 16, 16, 32
    x, xt = _bf16(rng.normal(size=(n, h, w, c)))
    got = pool2x(xt, mode)
    yq = pool2x_packed(pack_nhwc(jnp.asarray(x, jnp.bfloat16)), c, mode,
                       wq=w // 4, interpret=True)
    # the JAX kernel emits the next level's 2c-slot packing
    want = np.asarray(unpack_nhwc(yq, 2 * c, w // 2), np.float32)[..., :c]
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_head_tail_matches_pallas():
    rng = np.random.default_rng(11)
    n, hi, wi, k = 1, 4, 128, 11
    xs = rng.normal(size=(n, hi, 64, wi)).astype(np.float32)
    xs[:, :, k:] = 0.0  # the JAX kernel wants zeros past c_in
    x, _ = _bf16(xs)
    w3, w3t = _bf16(rng.normal(size=(3, 3, k, k)) * 0.1)
    b3 = (rng.normal(size=k) * 0.1).astype(np.float32)
    got = head_tail(torch.from_numpy(x.transpose(0, 1, 3, 2)).to(BF), w3t,
                    torch.from_numpy(b3))
    m = head_tail_fused(jnp.asarray(x), jnp.asarray(w3), jnp.asarray(b3),
                        interpret=True)
    want = np.asarray(dephase_transpose(m, wi), np.float32)
    assert got.shape == want.shape == (n, k, 2 * hi, 2 * wi)
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err < 2e-2, err


@pytest.fixture(scope="module")
def modules():
    """The three port modules on the numpy weights, float32, eval."""
    interp, flow, fusion = port_sff_models(K, sff_variables(K, seed=30))
    return {"ifnet": interp, "fusionnet": flow, "unet_sff": fusion}


def _pair_inputs(seed, n=1, h=32, w=64):
    """A 2-channel gray pair and its replicated-gray 6-channel input."""
    g = np.random.default_rng(seed).random((n, h, w, 2), dtype=np.float32)
    x2 = torch.from_numpy(g)
    x6 = torch.from_numpy(np.repeat(g, 3, axis=-1))
    return x2, x6


def _nrmse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2)) / (want.std() + 1e-6))


SERVE = {"ifnet": ifnet_serve, "fusionnet": fusionnet_serve,
         "unet_sff": unet_sff_serve}


@pytest.mark.parametrize("name", list(SERVE))
def test_serve_matches_bf16_module(modules, name):
    x2, x6 = _pair_inputs(1)
    model = modules[name]
    module_bf16 = set_compute_dtype(copy.deepcopy(model), BF)
    with torch.inference_mode():
        got = SERVE[name](model, x2).float()
        want = module_bf16(x6.permute(0, 3, 1, 2)).float().permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert _nrmse(got, want) < 0.05, _nrmse(got, want)


def test_gray_pair_fold_exact(modules):
    """The folded conv equals the 6-channel one on replicated input (float32
    rounding only), and the 2- and 6-channel serving inputs agree within
    tests/test_serving.py::test_gray_pair_fold_exact's bound (the folded
    weights round to bf16 once, the 6-channel ones three times)."""
    x2, x6 = _pair_inputs(2)
    conv = modules["unet_sff"].conv_encode1[0]
    folded = fold_gray_pair_conv(conv)
    assert folded.weight.shape[1] == 2 and conv.weight.shape[1] == 6
    with torch.no_grad():
        y6 = F.conv2d(x6.permute(0, 3, 1, 2), conv.weight, conv.bias, padding=1)
        y2 = F.conv2d(x2.permute(0, 3, 1, 2), folded.weight, folded.bias,
                      padding=1)
    np.testing.assert_allclose(y2.numpy(), y6.numpy(), rtol=1e-5, atol=1e-5)
    with torch.inference_mode():
        s2 = unet_sff_serve(modules["unet_sff"], x2).float().numpy()
        s6 = unet_sff_serve(modules["unet_sff"], x6).float().numpy()
    np.testing.assert_allclose(s2, s6, atol=0.02, rtol=0.05)


def test_refusals(modules):
    x = torch.zeros((1, 16, 16, 32), dtype=BF)
    w = torch.zeros((3, 3, 32, 32), dtype=BF)
    one = torch.ones(32)
    with pytest.raises(ValueError, match="bfloat16 only"):
        SFFPipeline(modules["ifnet"], modules["fusionnet"], modules["unet_sff"],
                    "cpu", dtype=PARITY_DTYPE, packed_conv=True)
    with pytest.raises(TypeError):
        conv3x3_fused(x.float(), w, one, one)
    with pytest.raises(ValueError, match="3,3,Cin,Cout"):
        conv3x3_fused(x, w[:, :, :16], one, one)
    with pytest.raises(ValueError, match="at most 64"):
        conv3x3_fused(torch.zeros((1, 8, 8, 96), dtype=BF),
                      torch.zeros((3, 3, 96, 32), dtype=BF), one, one)
    with pytest.raises(ValueError, match="residual"):
        conv3x3_fused(x, w, one, one, residual=x[:, :8])
    with pytest.raises(ValueError, match="residual"):
        deconv2x_fused(x, w[..., :16], *fold_affine(16), "relu", residual=x)
    with pytest.raises(ValueError, match="mode"):
        pool2x(x, "min")
    with pytest.raises(TypeError):
        pool2x(x.float())
    with pytest.raises(ValueError, match="Cin <= Cx"):
        head_tail(x, torch.zeros((3, 3, 48, 8), dtype=BF), torch.zeros(8))
    # a tensor that is neither on the CPU nor on a card never reaches a
    # plain version
    with pytest.raises(ValueError, match="unsupported device"):
        pool2x(x.to("meta"))
