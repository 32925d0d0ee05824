"""The port's tiled inference (sstem_tpu_torch/infer/tiles.py), device mesh
and row sharding (sstem_tpu_torch/parallel/), sharded SFF stack restore
(``SFFPipeline.restore_stack_sharded``) and debug tools
(sstem_tpu_torch/utils/debug.py) against the JAX package, on the same seeded
numpy inputs and weights.

JAX runs on its 8 virtual CPU devices (tests/conftest.py), each function
under one ``jax.jit`` (one compile, which the persistent cache keeps, where
eager dispatch compiles op by op). Torch has one
'cpu' device, so the port's meshes repeat it (``devices=["cpu"] * n``): the
slabs and shards then run one after another in this process, with the same
arithmetic as on distinct devices.

Bounds: the tile functions and the 5x5 box filter 1e-6 (float32, one
window op); ``spatial_apply`` on a two-conv net 1e-5, as
tests/test_spatial.py bounds it; the sharded restore (float32, K=5) within
1 uint8 level on under 1e-3 of each output's pixels, as
tests/test_pipeline_sharded.py bounds the JAX package's own, and flow within
5e-4 abs.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sstem_tpu.data.synthetic import synth_stack
from sstem_tpu.infer import tiles as jax_tiles
from sstem_tpu.infer.pipeline import SFFPipeline as JaxSFFPipeline
from sstem_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sstem_tpu.parallel.spatial import spatial_apply as jax_spatial_apply
from sstem_tpu.utils import debug as jax_debug
from sstem_tpu_torch.infer import (
    SFFPipeline,
    infer_full,
    infer_tiled,
    pad_to_multiple,
    tile_image,
    untile,
)
from sstem_tpu_torch.parallel import make_mesh, replicate, spatial_apply
from sstem_tpu_torch.utils import StepTimer, enable_nan_checks, profile_trace

from _torch_port import port_sff_models, sff_variables

K = 5
RNG_SEED = 91


def _cpu_mesh(n_data, n_space=1):
    return make_mesh(n_data=n_data, n_space=n_space,
                     devices=["cpu"] * (n_data * n_space))


def _jax_box5(x):
    k = jnp.ones((5, 5, 1, 1), jnp.float32) / 25.0
    return jax.lax.conv_general_dilated(
        x, k, (1, 1), [(2, 2), (2, 2)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


class Box5(torch.nn.Module):
    """The 5x5 mean filter, zero-padded, on (N, H, W, 1)."""

    def forward(self, x):
        w = torch.full((1, 1, 5, 5), 1 / 25.0, dtype=x.dtype, device=x.device)
        return F.conv2d(x.permute(0, 3, 1, 2), w, padding=2).permute(0, 2, 3, 1)


def _image(shape, seed=RNG_SEED):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


# ---------------------------------------------------------------------------
# tiles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["edge", "constant"])
def test_pad_to_multiple_matches_jax(mode):
    x = _image((2, 37, 45, 2))
    want, size = jax_tiles.pad_to_multiple(jnp.asarray(x), 16, mode=mode)
    got, got_size = pad_to_multiple(torch.from_numpy(x), 16, mode=mode)
    assert got_size == size
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hw, tile, halo, mode", [
    ((75, 61), 32, 8, "constant"), ((64, 64), 32, 0, "constant"),
    ((50, 70), 24, 6, "edge")])
def test_tile_image_untile_match_jax(hw, tile, halo, mode):
    img = _image((*hw, 2))
    want, grid = jax_tiles.tile_image(jnp.asarray(img), tile, halo, mode)
    got, got_grid = tile_image(torch.from_numpy(img), tile, halo, mode)
    assert got_grid == grid
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(untile(got, got_grid, halo).numpy(), img)


def test_infer_full_matches_jax():
    x = _image((2, 50, 45, 1))
    want = jax.jit(lambda xx: jax_tiles.infer_full(_jax_box5, xx))(
        jnp.asarray(x))
    got = infer_full(Box5(), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_dev", [None, 2])
def test_infer_tiled_matches_jax(n_dev):
    """6 tiles in batches of 4, the last filled by repeating its tile; with
    a 2-device mesh each batch is split in two along 'data', one part per
    device, each run on that device's replica."""
    img = _image((75, 61, 1))
    mesh = None if n_dev is None else jax_make_mesh(
        n_data=n_dev, devices=jax.devices()[:n_dev])
    want = jax.jit(lambda im: jax_tiles.infer_tiled(
        _jax_box5, im, tile=32, halo=8, mesh=mesh))(jnp.asarray(img))
    calls = []
    if n_dev is None:
        port_mesh, model = None, Box5()

        def apply_fn(x):
            calls.append((x.device, x.shape[0]))
            return model(x)
    else:
        port_mesh = _cpu_mesh(n_dev)
        replicas = replicate(Box5(), port_mesh)

        def apply_fn(x):
            calls.append((x.device, x.shape[0]))
            return replicas[x.device](x)
    got = infer_tiled(apply_fn, torch.from_numpy(img), tile=32, halo=8,
                      mesh=port_mesh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    per_call = 4 if n_dev is None else 2
    assert calls == [(torch.device("cpu"), per_call)] * (8 // per_call)


# ---------------------------------------------------------------------------
# mesh and row sharding
# ---------------------------------------------------------------------------

def test_make_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    mesh = make_mesh(n_data=2, n_space=4, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 2, "space": 4} and mesh.size == 8
    assert mesh.distinct_devices() == [torch.device("cpu")]
    with pytest.raises(ValueError, match="need 3x3 devices"):
        make_mesh(n_data=3, n_space=3, devices=["cpu"] * 8)


def _two_conv_weights():
    rng = np.random.default_rng(61)
    return (rng.standard_normal((3, 3, 1, 4)).astype(np.float32) / 3,
            rng.uniform(-0.1, 0.1, 4).astype(np.float32),
            rng.standard_normal((3, 3, 4, 1)).astype(np.float32) / 6,
            rng.uniform(-0.1, 0.1, 1).astype(np.float32))


def _jax_two_conv(weights):
    w1, b1, w2, b2 = (jnp.asarray(a) for a in weights)

    def conv(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))

    return lambda x: conv(jax.nn.relu(conv(x, w1) + b1), w2) + b2


def _port_two_conv(weights):
    w1, b1, w2, b2 = (torch.from_numpy(a) for a in weights)
    w1, w2 = (w.permute(3, 2, 0, 1) for w in (w1, w2))

    def fn(x):
        y = F.relu(F.conv2d(x.permute(0, 3, 1, 2), w1, b1, padding=1))
        return F.conv2d(y, w2, b2, padding=1).permute(0, 2, 3, 1)

    return fn


@pytest.mark.parametrize("n_data, n_space, batch_axis, halo", [
    (1, 8, None, 8), (2, 4, "data", 8), (1, 8, None, 0)])
def test_spatial_apply_matches_jax(n_data, n_space, batch_axis, halo):
    """The two-conv net of tests/test_spatial.py on shared numpy weights:
    sp 8, dp 2 x sp 4 with the batch split along 'data', and halo 0 (no
    exchange)."""
    weights = _two_conv_weights()
    x = np.random.default_rng(62).standard_normal((2, 64, 48, 1)).astype(
        np.float32)
    mesh = jax_make_mesh(n_data=n_data, n_space=n_space)
    want = jax.jit(lambda xx: jax_spatial_apply(
        _jax_two_conv(weights), xx, mesh, halo, batch_axis=batch_axis))(
            jnp.asarray(x))
    got = spatial_apply(_port_two_conv(weights), torch.from_numpy(x),
                        _cpu_mesh(n_data, n_space), halo, batch_axis=batch_axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the sharded stack restore
# ---------------------------------------------------------------------------

SHARDED = {"dp2_sp2_halo32": (2, 2, 32), "dp4_halo0": (4, 1, 0)}
IDS = [1, 4]  # dp 4 fills its one group by repeating the ids


@pytest.fixture(scope="module")
def pipelines():
    """(JAX pipeline, port pipeline) on the same numpy weights, float32."""
    iv, fv, uv = sff_variables(K, seed=40)
    return (JaxSFFPipeline(interp_vars=iv, flow_vars=fv, fusion_vars=uv,
                           kernel_size=K, packed_conv=False),
            SFFPipeline(*port_sff_models(K, (iv, fv, uv)), device="cpu"))


@pytest.fixture(scope="module")
def sharded_jax(pipelines):
    """The JAX restore on jax.devices()[:4], one call per configuration."""
    stack = synth_stack(6, 128, 96, seed=7)
    return stack, {
        name: pipelines[0].restore_stack_sharded(
            stack, IDS, jax_make_mesh(n_data=dp, n_space=sp,
                                      devices=jax.devices()[:4]), halo=halo)
        for name, (dp, sp, halo) in SHARDED.items()}


def _assert_levels(got, want, keys=("interp", "fused", "warped", "stitch")):
    assert sorted(got) == sorted(want)
    for i in want:
        assert set(got[i]) == set(want[i])
        for k in keys:
            assert got[i][k].dtype == np.uint8
            assert got[i][k].shape == want[i][k].shape, (i, k)
            d = np.abs(got[i][k].astype(np.int16) - want[i][k].astype(np.int16))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3, (
                i, k, d.max(), (d > 0).mean())


@pytest.mark.parametrize("config", sorted(SHARDED))
def test_restore_stack_sharded_matches_jax(pipelines, sharded_jax, config):
    dp, sp, halo = SHARDED[config]
    stack, want = sharded_jax
    got = pipelines[1].restore_stack_sharded(stack, IDS, _cpu_mesh(dp, sp),
                                             halo=halo)
    _assert_levels(got, want[config])
    for i in IDS:
        assert got[i]["flow"].dtype == np.float32
        np.testing.assert_allclose(got[i]["flow"], want[config][i]["flow"],
                                   rtol=0, atol=5e-4)


@pytest.mark.parametrize("case", ["pad", "halo", "boundary"])
def test_restore_stack_sharded_rejects_as_jax(pipelines, case):
    """TEST.pad != 0, a halo not a multiple of 32 and a damaged id without
    both z-neighbours are refused by both packages before any work."""
    jax_pipe, pipe = pipelines
    stack = synth_stack(6, 32, 32, seed=7)
    ids, halo = ([0, 2] if case == "boundary" else [2]), (
        48 if case == "halo" else 32)
    if case == "pad":
        jax_pipe = copy.copy(jax_pipe)
        pipe = copy.copy(pipe)
        jax_pipe.pad = pipe.pad = 2
    match = {"pad": "TEST.pad", "halo": "multiple of 32",
             "boundary": "z-neighbor"}[case]
    with pytest.raises((AssertionError, ValueError), match=match):
        jax_pipe.restore_stack_sharded(
            stack, ids, jax_make_mesh(n_data=2, n_space=2,
                                      devices=jax.devices()[:4]), halo=halo)
    with pytest.raises(ValueError, match=match):
        pipe.restore_stack_sharded(stack, ids, _cpu_mesh(2, 2), halo=halo)


# ---------------------------------------------------------------------------
# debug tools
# ---------------------------------------------------------------------------

def test_enable_nan_checks_raises_as_jax_does():
    """A non-finite module output raises FloatingPointError while the checks
    are on, as a non-finite result does under JAX's debug flags; nothing
    raises after ``enable_nan_checks(False)``."""
    conv = torch.nn.Conv2d(1, 1, 3, padding=1)
    bad = torch.ones(1, 1, 4, 4)
    bad[0, 0, 1, 2] = float("inf")
    prev = (jax.config.jax_debug_nans, jax.config.jax_debug_infs)
    try:
        enable_nan_checks(True)
        jax_debug.enable_nan_checks(True)
        assert torch.is_anomaly_enabled()
        conv(torch.ones(1, 1, 4, 4))
        with pytest.raises(FloatingPointError):
            conv(bad)
        with pytest.raises(FloatingPointError):
            jnp.log(jnp.zeros(2)).block_until_ready()
    finally:
        enable_nan_checks(False)
        jax.config.update("jax_debug_nans", prev[0])
        jax.config.update("jax_debug_infs", prev[1])
    assert not torch.is_anomaly_enabled()
    assert not torch.isfinite(conv(bad)).all()


def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(str(tmp_path)):
        Box5()(torch.ones(1, 8, 8, 1))
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert json.loads(traces[0].read_text())["traceEvents"]


def test_step_timer_report_as_jax():
    reports = []
    for timer in (StepTimer(), jax_debug.StepTimer()):
        for name in ("load", "restore", "load"):
            with timer.phase(name):
                pass
        reports.append(timer.report())
    got, want = reports
    assert list(got) == list(want) == ["load", "restore"]
    for name in want:
        assert set(got[name]) == set(want[name]) == {"total_s", "mean_s"}
        assert all(isinstance(v, float) and v >= 0 for v in got[name].values())
    assert got["load"]["mean_s"] == pytest.approx(got["load"]["total_s"] / 2)
