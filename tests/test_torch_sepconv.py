"""Port sepconv (sstem_tpu_torch/kernels/sepconv.py) vs the JAX sepconv.

The same numpy inputs go through the port's plain versions (what the
wrappers run on CPU tensors) and through JAX's ``sepconv_planar`` in Pallas
interpret mode and its XLA oracles: ``sepconv_reference_planar`` for the
forward, ``_bwd_xla_planar`` (behind ``jax.vjp``) for the backward. Maps are
positive with taps summing to about 1 per pixel, so outputs are unit-range
and the 1e-5 tolerance is about 100 float32 ulps of accumulation-order
difference.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sstem_tpu.kernels import (
    sepconv_planar as jax_sepconv_planar,
    sepconv_reference_planar,
    set_sepconv_impl,
)
from sstem_tpu.kernels.sepconv import _bwd_xla_planar
from sstem_tpu_torch.kernels import (
    sepconv_planar,
    sepconv_planar_bwd,
    sepconv_planar_plain,
)

torch.set_num_threads(1)

TOL = 1e-5


def _case(seed, n, c, h, w, k, maps_dtype):
    rng = np.random.default_rng(seed)
    im = rng.random((n, c, h + k - 1, w + k - 1), dtype=np.float32)
    v = rng.random((n, k, h, w), dtype=np.float32) * (2.0 / k)
    hz = rng.random((n, k, h, w), dtype=np.float32) * (2.0 / k)
    if maps_dtype == "bfloat16":
        # round once in numpy so both sides see the same bf16 values
        v = torch.from_numpy(v).bfloat16()
        hz = torch.from_numpy(hz).bfloat16()
        return (im, v, hz, jnp.asarray(v.float().numpy(), jnp.bfloat16),
                jnp.asarray(hz.float().numpy(), jnp.bfloat16))
    return (im, torch.from_numpy(v), torch.from_numpy(hz), jnp.asarray(v),
            jnp.asarray(hz))


@pytest.mark.parametrize("n,c,h,w,k,maps_dtype", [
    (1, 1, 9, 13, 5, "float32"),
    (2, 3, 7, 10, 5, "bfloat16"),
    (1, 1, 11, 6, 11, "bfloat16"),
    (1, 3, 5, 9, 11, "float32"),
])
def test_plain_sepconv_matches_jax(n, c, h, w, k, maps_dtype):
    im, v_t, h_t, v_j, h_j = _case(k * 100 + c, n, c, h, w, k, maps_dtype)
    got = sepconv_planar(torch.from_numpy(im), v_t, h_t)
    assert got.dtype == torch.float32 and got.shape == (n, c, h, w)
    ref = np.asarray(sepconv_reference_planar(jnp.asarray(im), v_j, h_j))
    set_sepconv_impl("pallas_interpret")
    try:
        pallas = np.asarray(jax_sepconv_planar(jnp.asarray(im), v_j, h_j))
    finally:
        set_sepconv_impl("auto")
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=TOL)


def test_bf16_image_returns_bf16_from_f32_accumulation():
    """A bf16 image gives a bf16 output, rounded once from the f32 sum."""
    im, v_t, h_t, _, _ = _case(5, 1, 1, 6, 7, 5, "bfloat16")
    im_b = torch.from_numpy(im).bfloat16()
    got = sepconv_planar(im_b, v_t, h_t)
    assert got.dtype == torch.bfloat16
    want = sepconv_planar_plain(im_b.float(), v_t, h_t).bfloat16()
    assert torch.equal(got, want)


def _port_grads(im, v_t, h_t, g):
    """(dimage, dV, dH) of the port's autograd.Function for output grad g."""
    image = torch.from_numpy(im).requires_grad_()
    v_t = v_t.clone().requires_grad_()
    h_t = h_t.clone().requires_grad_()
    out = sepconv_planar(image, v_t, h_t)
    out.backward(torch.from_numpy(g))
    return image.grad, v_t.grad, h_t.grad


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("n,c,h,w,k", [(2, 1, 9, 14, 5), (1, 3, 12, 7, 11)])
def test_plain_sepconv_backward_matches_jax_vjp(n, c, h, w, k, impl):
    """Float32: dV and dH within 1e-5 of max(|dV|, |dH|) (the f32 sums run
    in another order); the image gradient is exactly zero on both sides."""
    im, v_t, h_t, v_j, h_j = _case(k * 10 + c, n, c, h, w, k, "float32")
    g = np.random.default_rng(k + c).standard_normal(
        (n, c, h, w)).astype(np.float32)
    dim, dv, dh = _port_grads(im, v_t, h_t, g)
    set_sepconv_impl(impl)
    try:
        _, vjp = jax.vjp(jax_sepconv_planar, jnp.asarray(im), v_j, h_j)
        jdim, jdv, jdh = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    finally:
        set_sepconv_impl("auto")
    assert dv.dtype == dh.dtype == torch.float32
    assert not dim.any() and not jdim.any()
    tol = TOL * max(np.abs(jdv).max(), np.abs(jdh).max())
    np.testing.assert_allclose(dv.numpy(), jdv, rtol=0, atol=tol)
    np.testing.assert_allclose(dh.numpy(), jdh, rtol=0, atol=tol)


def test_plain_sepconv_backward_bf16_maps_rounds_once():
    """bf16 maps: dV and dH are f32 sums rounded once to bf16. The Pallas
    kernel instead rounds dH to bf16 after every u step, so the reference
    here is the JAX oracle on f32-upcast inputs, rounded once; the bound is
    one bf16 ulp of the value (the two f32 sums differ in order only)."""
    n, c, h, w, k = 2, 1, 10, 13, 5
    im, v_t, h_t, _, _ = _case(55, n, c, h, w, k, "bfloat16")
    g = np.random.default_rng(56).standard_normal((n, c, h, w)).astype(np.float32)
    dim, dv, dh = _port_grads(im, v_t, h_t, g)
    assert dv.dtype == dh.dtype == torch.bfloat16 and not dim.any()
    want = _bwd_xla_planar(jnp.asarray(im), jnp.asarray(v_t.float().numpy()),
                           jnp.asarray(h_t.float().numpy()), jnp.asarray(g))
    for got, ref in zip((dv, dh), want):
        ref = torch.from_numpy(np.array(ref)).bfloat16().float()
        ulp = torch.exp2(torch.floor(torch.log2(
            ref.abs().clamp_min(2.0 ** -126))) - 7)
        assert bool(((got.float() - ref).abs() <= ulp).all())


def test_plain_sepconv_gradcheck_float64():
    """Finite differences in float64 (the plain versions keep float64)."""
    rng = np.random.default_rng(57)
    im = torch.from_numpy(rng.random((1, 2, 6, 7)))
    v = torch.from_numpy(rng.random((1, 3, 4, 5))).requires_grad_()
    h = torch.from_numpy(rng.random((1, 3, 4, 5))).requires_grad_()
    assert torch.autograd.gradcheck(sepconv_planar, (im, v, h))


def test_sepconv_refuses_inputs_that_require_grad():
    """Inputs that require grad get the reference's first-order gradient
    (the image's exactly zero); a second-order gradient is refused."""
    im, v_t, h_t, _, _ = _case(6, 1, 1, 4, 4, 3, "float32")
    image = torch.from_numpy(im).requires_grad_()
    v_t.requires_grad_()
    out = sepconv_planar(image, v_t, h_t)
    g = torch.ones_like(out, requires_grad=True)
    dim, dv = torch.autograd.grad(out, (image, v_t), g, create_graph=True)
    assert torch.equal(dim, torch.zeros_like(image))
    want, _ = sepconv_planar_bwd(image.detach(), v_t.detach(), h_t, g.detach())
    assert torch.equal(dv, want)
    with pytest.raises(RuntimeError, match="differentiate"):
        dv.sum().backward()


def test_sepconv_rejects_mismatched_padding():
    im, v_t, h_t, _, _ = _case(7, 1, 1, 4, 4, 3, "float32")
    with pytest.raises(ValueError, match="padded"):
        sepconv_planar(torch.from_numpy(im)[..., 1:], v_t, h_t)
