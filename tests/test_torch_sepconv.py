"""Port sepconv (sstem_tpu_torch/kernels/sepconv.py) vs the JAX sepconv.

The same numpy inputs go through the port's plain version (what the wrapper
runs on CPU tensors) and through JAX's ``sepconv_planar`` in Pallas interpret
mode and its XLA oracle ``sepconv_reference_planar``. Maps are positive with
taps summing to about 1 per pixel, so outputs are unit-range and the 1e-5
tolerance is about 100 float32 ulps of accumulation-order difference.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sstem_tpu.kernels import (
    sepconv_planar as jax_sepconv_planar,
    sepconv_reference_planar,
    set_sepconv_impl,
)
from sstem_tpu_torch.kernels import sepconv_planar, sepconv_planar_plain

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


def test_sepconv_refuses_inputs_that_require_grad():
    im, v_t, h_t, _, _ = _case(6, 1, 1, 4, 4, 3, "float32")
    with pytest.raises(RuntimeError, match="requires grad"):
        sepconv_planar(torch.from_numpy(im), v_t.requires_grad_(), h_t)


def test_sepconv_rejects_mismatched_padding():
    im, v_t, h_t, _, _ = _case(7, 1, 1, 4, 4, 3, "float32")
    with pytest.raises(ValueError, match="padded"):
        sepconv_planar(torch.from_numpy(im)[..., 1:], v_t, h_t)
