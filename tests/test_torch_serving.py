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
tests/test_serving.py sets between the JAX serving forwards and flax. The
SP U-Nets' serving forwards are held to the JAX ones (kernels in interpret
mode) by the same bound.
"""

import copy
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
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
from sstem_tpu.models import UNetSP as JaxUNetSP
from sstem_tpu.models.serving import ifnet_serve as jax_ifnet_serve
from sstem_tpu.models.serving import unet_sp_serve as jax_unet_sp_serve
from sstem_tpu_torch.compat import (
    ifnet_state_dict_from_jax,
    unet_sp_state_dict_from_jax,
)
from sstem_tpu_torch.config import PARITY_DTYPE
from sstem_tpu_torch.infer.pipeline import SFFPipeline
from sstem_tpu_torch.kernels import (
    conv3x3_fused,
    deconv2x_fused,
    fold_affine,
    head_tail,
    pool2x,
)
from sstem_tpu_torch.models.layers import cast_conv_weights, skip_init
from sstem_tpu_torch.models.serving import (
    fold_gray_pair_conv,
    fusionnet_serve,
    fusionnet_sp_serve,
    ifnet_serve,
    unet_sff_serve,
    unet_sp_serve,
)

from _torch_port import (
    ifnet_variables,
    numpy_variables,
    port_module,
    port_sff_models,
    sff_variables,
)

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


# every narrow (cin, cout) of the packed paths (conv3x3's narrow_in and
# narrow_out designs on the card), held against the JAX kernel as the JAX
# serving path runs it there: the real channels zero-padded to its packing
# width (serving.py: _packed_conv_args pads the weights with zeros and the
# scale with ones, pack_nhwc(pad_c=...) the input and residual), the
# padded output channels dropped
@pytest.mark.parametrize("cin,cout,act,res", [
    (2, 32, "relu", None), (2, 6, "relu", None), (6, 6, "relu", "post"),
    (6, 32, "leaky", None), (32, 1, "relu", None), (32, 2, None, None),
    (1, 64, "relu", None), (64, 1, None, "pre")])
def test_conv3x3_narrow_matches_pallas(cin, cout, act, res):
    rng = np.random.default_rng(100 * cin + cout)
    n, h, w = 1, 16, 16
    c = max(32, cin, cout)  # the packing width
    x, xt = _bf16(rng.normal(size=(n, h, w, cin)))
    wk, wt = _bf16(rng.normal(size=(3, 3, cin, cout)) * (2.0 / (9 * cin)) ** 0.5)
    scale, shift = _affine(rng, cout)
    r, rt = _bf16(rng.normal(size=(n, h, w, cout))) if res else (None, None)
    got = conv3x3_fused(xt, wt, torch.from_numpy(scale), torch.from_numpy(shift),
                        act, rt, res == "pre")
    p = 128 // c
    wpad = np.zeros((3, 3, c, c), np.float32)
    wpad[:, :, :cin, :cout] = wk
    spad = np.ones(c, np.float32)
    spad[:cout] = scale
    tpad = np.zeros(c, np.float32)
    tpad[:cout] = shift

    def packed(a):
        return pack_nhwc(jnp.asarray(a, jnp.bfloat16), pad_c=c - a.shape[-1])

    yq = conv3x3_packed(
        packed(x), build_packed_weights(jnp.asarray(wpad, jnp.bfloat16), p),
        jnp.tile(spad, p), jnp.tile(tpad, p), act, wq=w // p,
        residual=None if res is None else packed(r),
        residual_pre_affine=res == "pre", interpret=True)
    want = np.asarray(unpack_nhwc(yq, c, w, drop_c=c - cout), np.float32)
    assert got.dtype == BF and got.shape == want.shape == (n, h, w, cout)
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
    module_bf16 = cast_conv_weights(copy.deepcopy(model), BF)
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
    with pytest.raises(ValueError, match="at most 128"):
        conv3x3_fused(torch.zeros((1, 8, 8, 160), dtype=BF),
                      torch.zeros((3, 3, 160, 32), dtype=BF), one, one)
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


@pytest.mark.parametrize("cin,cout,act,res", [(64, 128, "relu", None),
                                              (128, 128, "relu", "pre"),
                                              (128, 128, "leaky", "post"),
                                              (128, 64, "relu", None)])
def test_conv3x3_128_channels_matches_pallas(cin, cout, act, res):
    """The SP U-Net's half-resolution convs: 64 -> 128 (down1 conv0),
    128 -> 128 plain and with the residual before the affine (the split
    concat conv of up3) or after it, 128 -> 64 (up3 conv1). The JAX kernel
    packs one pixel per 128 lanes; fewer real channels are zero-padded in
    and out and sliced off, as its serving forward does
    (``_packed_conv_args``)."""
    rng = np.random.default_rng(cin + cout + len(str(res)))
    n, h, w = 1, 16, 16
    x, xt = _bf16(rng.normal(size=(n, h, w, cin)))
    wk, wt = _bf16(rng.normal(size=(3, 3, cin, cout)) * (2.0 / (9 * cin)) ** 0.5)
    scale, shift = _affine(rng, cout)
    r, rt = _bf16(rng.normal(size=(n, h, w, cout))) if res else (None, None)
    got = conv3x3_fused(xt, wt, torch.from_numpy(scale), torch.from_numpy(shift),
                        act, rt, res == "pre")
    pad_out = [(0, 0)] * 3 + [(0, 128 - cout)]
    yq = conv3x3_packed(
        pack_nhwc(jnp.asarray(x, jnp.bfloat16), pad_c=128 - cin),
        build_packed_weights(jnp.asarray(
            np.pad(wk, [(0, 0), (0, 0), (0, 128 - cin), (0, 128 - cout)]),
            jnp.bfloat16), 1),
        jnp.asarray(np.pad(scale, (0, 128 - cout), constant_values=1.0)),
        jnp.asarray(np.pad(shift, (0, 128 - cout))), act, wq=w,
        residual=None if res is None else pack_nhwc(
            jnp.asarray(np.pad(r, pad_out), jnp.bfloat16)),
        residual_pre_affine=res == "pre", interpret=True)
    want = np.asarray(unpack_nhwc(yq, 128, w), np.float32)[..., :cout]
    assert got.dtype == BF and got.shape == want.shape
    _assert_bf16_close(got.float().numpy(), want)


@pytest.fixture(scope="module")
def sp_modules():
    """The SP U-Nets' JAX variables, port modules (float32, eval) and the
    JAX serving forward, jitted once with its kernels in interpret mode."""
    dv = numpy_variables(JaxUNetSP(1), 50, (1, 64, 64, 1), train=True)
    fv = numpy_variables(JaxUNetSP(1), 51, (1, 64, 64, 1), train=True)
    ports = []
    for name, v in (("UNetSP", dv), ("FusionNetSP", fv)):
        with skip_init():  # every value is loaded next
            model = port_module(name)
        model.load_state_dict(unet_sp_state_dict_from_jax(v), strict=True)
        ports.append(model.eval())
    serve = jax.jit(functools.partial(jax_unet_sp_serve, interpret=True))
    return (dv, fv), ports, serve


@pytest.mark.parametrize("name", ["unet_sp", "fusionnet_sp"])
def test_sp_serve_matches_jax_serve(sp_modules, name):
    """The port's SP serving forwards against the JAX ones with the Pallas
    kernels in interpret mode, both bf16: NRMSE below 0.05 of the output's
    std (tests/test_serving.py's bound between a packed forward and flax).
    The JAX ``fusionnet_sp_serve`` is ``unet_sp_backbone_serve`` of the
    inputs' sum (serving.py:649-652), so both cases run the one jitted JAX
    forward (tracing it in interpret mode takes seconds)."""
    (dv, fv), (denoise, fusion), serve = sp_modules
    rng = np.random.default_rng(52)
    a = rng.random((1, 32, 32, 1), dtype=np.float32)
    b = rng.random((1, 32, 32, 1), dtype=np.float32)
    with torch.inference_mode():
        if name == "unet_sp":
            got = unet_sp_serve(denoise, torch.from_numpy(a))
            want = serve(dv, jnp.asarray(a))
        else:
            got = fusionnet_sp_serve(fusion, torch.from_numpy(a),
                                     torch.from_numpy(b))
            want = serve(fv, jnp.asarray(a) + jnp.asarray(b))
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _nrmse(got, want) < 0.05, _nrmse(got, want)


@pytest.fixture(scope="module")
def two_frame():
    """The two-frame IFNet(11) at 64^2: numpy weights, the port module
    (float32, eval) and the JAX ``ifnet_serve(n_frames=2)`` outputs with its
    Pallas kernels in interpret mode, on the 2-channel gray pair and on 6
    distinct channels with ``assume_gray=False``, each computed once."""
    k = 11
    iv = ifnet_variables(k, seed=60, n_frames=2)
    with skip_init():  # every value is loaded next
        model = port_module("IFNet", k, 2)
    model.load_state_dict(ifnet_state_dict_from_jax(iv, 2), strict=True)
    rng = np.random.default_rng(61)
    inputs = {"pair": rng.random((1, 64, 64, 2), dtype=np.float32),
              "rgb": rng.random((1, 64, 64, 6), dtype=np.float32)}
    serve = jax.jit(functools.partial(jax_ifnet_serve, kernel_size=k,
                                      n_frames=2, interpret=True),
                    static_argnames=("assume_gray",))
    want = {form: np.asarray(serve(iv, jnp.asarray(x),
                                   assume_gray=form == "pair"), np.float32)
            for form, x in inputs.items()}
    return model.eval(), inputs, want


@pytest.mark.parametrize("tail", ["cudnn", "fused", "batched"],
                         ids=["cudnn_tail", "fused_tail", "batched_tail"])
@pytest.mark.parametrize("form", ["pair", "rgb"])
def test_ifnet_serve_two_frame_matches_jax_serve(two_frame, form, tail):
    """The port's ``ifnet_serve(n_frames=2)`` against the JAX one (Pallas in
    interpret mode), both bf16: NRMSE below 0.05 of the output's std, the
    bound tests/test_serving.py::test_ifnet_serve_two_frame sets between the
    JAX serving forward and flax. ``pair``: the 2-channel gray pair (first
    conv pair-folded); ``rgb``: 6 channels with ``assume_gray=False``, each
    sepconv on 3 channels and their mean. The head tails run on cuDNN's
    upsample and conv, on the head-tail kernel's plain version, or batched
    (all eight in one upsample and one grouped conv3, the JAX
    ``SSTEM_BATCHED_HEAD_TAIL=1``, the same math as its planar tail); the
    JAX side runs its planar tail (its fused tail needs W/2 % 128 == 0)."""
    model, inputs, want = two_frame
    with torch.inference_mode():
        got = ifnet_serve(model, torch.from_numpy(inputs[form]), n_frames=2,
                          assume_gray=form == "pair",
                          fused_head_tail=tail == "fused",
                          batched_head_tail=tail == "batched")
    assert got.dtype == torch.float32 and got.shape == want[form].shape == (
        1, 64, 64, 2)
    assert _nrmse(got, want[form]) < 0.05, _nrmse(got, want[form])


def test_ifnet_serve_refusals(two_frame):
    model = two_frame[0]
    with pytest.raises(ValueError, match="n_frames=1 but the model has 2"):
        ifnet_serve(model, torch.zeros((1, 32, 32, 2)))
    with pytest.raises(ValueError, match="gray pair"):
        ifnet_serve(model, torch.zeros((1, 32, 32, 2)), n_frames=2,
                    assume_gray=False)
