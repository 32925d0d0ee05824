"""Port ops (sstem_tpu_torch/ops, infer/tiles.py, kernels/warp.py, data,
kernels/_build.py) vs their JAX counterparts on the same numpy inputs.

Warp, pad, resize and pad-to-stride are held to 1e-6 abs on unit-range
images (float32 rounding of the same arithmetic); flow synthesis and the
synthetic stack are numpy on both sides and must be identical.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from sstem_tpu.data.synthetic import synth_stack as jax_synth_stack
from sstem_tpu.infer.tiles import pad_to_multiple as jax_pad_to_multiple
from sstem_tpu.kernels.warp_band import warp_band
from sstem_tpu.ops import (
    gen_flow_np as jax_gen_flow_np,
    gen_line as jax_gen_line,
    replication_pad_2d as jax_replication_pad_2d,
    spatial_transform as jax_spatial_transform,
    upsample2x_planar_mxu,
    upsample_bilinear_align_corners as jax_upsample,
)
from sstem_tpu_torch.data import synth_stack
from sstem_tpu_torch.infer.tiles import pad_to_multiple
from sstem_tpu_torch.kernels import _build
from sstem_tpu_torch.kernels.warp import serving_warp
from sstem_tpu_torch.ops import (
    gen_flow_np,
    gen_line,
    replication_pad_2d,
    spatial_transform,
    upsample_bilinear_align_corners,
)

torch.set_num_threads(1)

TOL = 1e-6


def _fold_flow(n, h, w, seed):
    rng = np.random.default_rng(seed)
    flows = []
    for _ in range(n):
        k, b = gen_line((rng.uniform(0, h), 0.0), (rng.uniform(0, h), w - 1.0))
        _, flow2, _ = gen_flow_np(h, w, k, b, line_width=4, fold_width=16)
        flows.append(flow2)
    return np.stack(flows)


def _flow(case, n, h, w):
    rng = np.random.default_rng(11)
    if case == "fold":
        return _fold_flow(n, h, w, seed=12)
    if case == "far_oob":
        return rng.uniform(-3 * max(h, w), 3 * max(h, w),
                           (n, h, w, 2)).astype(np.float32)
    # border: integer and half-integer shifts of up to 2 px, so the border
    # rows and columns sample the zero pad, its edge and the clip collapse
    return (rng.integers(-4, 5, (n, h, w, 2)) / 2.0).astype(np.float32)


@pytest.mark.parametrize("case", ["fold", "far_oob", "border"])
def test_spatial_transform_matches_jax(case):
    n, h, w, c = 2, 23, 31, 3
    im = np.random.default_rng(10).random((n, h, w, c), dtype=np.float32)
    flow = _flow(case, n, h, w)
    got = spatial_transform(torch.from_numpy(im), torch.from_numpy(flow))
    want = np.asarray(jax_spatial_transform(jnp.asarray(im), jnp.asarray(flow)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_serving_warp_matches_warp_band_inside_its_envelope():
    n, h, w = 2, 64, 96
    im = np.random.default_rng(13).random((n, h, w, 1), dtype=np.float32)
    flow = _fold_flow(n, h, w, seed=14)
    got = serving_warp(torch.from_numpy(im), torch.from_numpy(flow))
    want, exact = warp_band(jnp.asarray(im), jnp.asarray(flow), win=64,
                            interpret=True)
    assert bool(exact)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_serving_warp_checks_its_inputs():
    im = torch.zeros(1, 8, 8, 1)
    with pytest.raises(ValueError, match="flow"):
        serving_warp(im, torch.zeros(1, 8, 8, 3))
    with pytest.raises(TypeError, match="float32"):
        serving_warp(im.double(), torch.zeros(1, 8, 8, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="unsupported device"):
        serving_warp(im.to("meta"), torch.zeros(1, 8, 8, 2, device="meta"))


@pytest.mark.parametrize("pad", [1, 3])
def test_replication_pad_matches_jax(pad):
    x = np.random.default_rng(15).random((2, 3, 9, 7), dtype=np.float32)
    got = replication_pad_2d(torch.from_numpy(x), pad)
    want = jax_replication_pad_2d(jnp.asarray(x.transpose(0, 2, 3, 1)), pad)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=0, atol=TOL)


def test_upsample_align_corners_matches_jax():
    x = np.random.default_rng(16).random((2, 5, 7, 11), dtype=np.float32)
    got = upsample_bilinear_align_corners(torch.from_numpy(x), 2).numpy()
    nhwc = jax_upsample(jnp.asarray(x.transpose(0, 2, 3, 1)), 2)
    mxu = upsample2x_planar_mxu(jnp.asarray(x), precision=lax.Precision.HIGHEST)
    np.testing.assert_allclose(got, np.asarray(nhwc).transpose(0, 3, 1, 2),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got, np.asarray(mxu), rtol=0, atol=TOL)


@pytest.mark.parametrize("hw", [(83, 101), (64, 96)])
def test_pad_to_multiple_is_edge_mode_like_jax(hw):
    x = np.random.default_rng(17).random((2, *hw, 3), dtype=np.float32)
    got, size = pad_to_multiple(torch.from_numpy(x), 32)
    want, want_size = jax_pad_to_multiple(jnp.asarray(x), 32)
    assert size == want_size == hw
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_flow_synthesis_and_synthetic_stack_equal_jax_package():
    p1, p2 = (10.0, 3.0), (40.0, 77.0)
    assert gen_line(p1, p2) == jax_gen_line(p1, p2)
    k, b = gen_line(p1, p2)
    for got, want in zip(gen_flow_np(48, 80, k, b), jax_gen_flow_np(48, 80, k, b)):
        assert np.array_equal(got, want)
    assert np.array_equal(synth_stack(3, 40, 56, seed=2),
                          jax_synth_stack(3, 40, 56, seed=2))


def test_kernel_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_nvcc", lambda: None)
    monkeypatch.setattr(_build, "LIBRARY", tmp_path / "libsstem_kernels.so")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sstem_tpu_torch\n"
        "for m in pkgutil.walk_packages(sstem_tpu_torch.__path__, "
        "'sstem_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'sstem_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('sstem_tpu_torch')]))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parent.parent)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20
