"""The port's micro-probes (sstem_tpu_torch/kernels/probes.py, the
128-channel conv3x3 and sstem_tpu_torch/tools/) vs the JAX probes' Pallas
kernels, run in interpret mode at small shapes.

The JAX kernels are closures inside ``main()`` and ``bench()`` of
tools/probe_dma_conv.py and tools/probe_gather.py and cannot be imported, so
each is restated here verbatim (with ``interpret=True`` added and the
shapes made arguments), citing its file and lines. Bounds:

  * copy, gather, roll: exact;
  * conv: one bf16 ulp of the value plus 2^-14 of the tensor's max |value|
    (tests/test_torch_serving.py's conv3x3 bound: both round once to bf16
    from f32 sums in another order).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sstem_tpu_torch.kernels import (
    conv3x3_fused,
    fold_affine,
    roll_dynamic,
    take_along_axis,
    tile_copy,
)
from sstem_tpu_torch.tools import micro_bench, probe_dma_conv, probe_gather

torch.set_num_threads(1)


# tools/probe_dma_conv.py:48-68 (copy_kernel, dma_copy)
def copy_kernel(src_hbm, out_ref, scratch, sem):
    t = pl.program_id(0)
    ty = scratch.shape[0]
    dma = pltpu.make_async_copy(
        src_hbm.at[pl.ds(t * ty, ty)], scratch, sem)
    dma.start()
    dma.wait()
    out_ref[...] = scratch[...]


def dma_copy(x, ty):
    rows = x.shape[0]
    return pl.pallas_call(
        copy_kernel,
        grid=(rows // ty,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.HBM)],
        out_specs=pl.BlockSpec(
            (ty,) + x.shape[1:], lambda t: (t,) + (0,) * (x.ndim - 1)),
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        scratch_shapes=[pltpu.VMEM((ty,) + x.shape[1:], x.dtype),
                        pltpu.SemaphoreType.DMA],
        interpret=True,
    )(x)


# tools/probe_dma_conv.py:84-122 (conv_kernel, pallas_conv)
def conv_kernel(ty, tx, x_hbm, w_ref, out_ref, b0, b1, b2, s0, s1, s2):
    t = pl.program_id(0)
    s = pl.program_id(1)
    bufs, sems = (b0, b1, b2), (s0, s1, s2)
    dmas = []
    for dx in range(3):
        dma = pltpu.make_async_copy(
            x_hbm.at[pl.ds(t * ty, ty + 2), pl.ds(s * tx + dx, tx)],
            bufs[dx], sems[dx])
        dma.start()
        dmas.append(dma)
    c = b0.shape[-1]
    co = out_ref.shape[-1]
    acc = jnp.zeros((ty * tx, co), jnp.float32)
    for dx in range(3):
        dmas[dx].wait()
        for dy in range(3):
            lhs = bufs[dx][dy:dy + ty].reshape(ty * tx, c)
            acc = acc + jax.lax.dot_general(
                lhs, w_ref[dy, dx],
                (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
    out_ref[...] = acc.reshape(ty, tx, co).astype(out_ref.dtype)


def pallas_conv(x, w, ty=8, tx=256):
    h, wdt, c = x.shape
    co = w.shape[-1]
    xp = jnp.pad(x, [(1, 1), (1, 1), (0, 0)])
    return pl.pallas_call(
        functools.partial(conv_kernel, ty, tx),
        grid=(h // ty, wdt // tx),
        in_specs=[
            pl.BlockSpec(memory_space=pltpu.HBM),
            pl.BlockSpec((3, 3, c, co), lambda t, s: (0, 0, 0, 0)),
        ],
        out_specs=pl.BlockSpec((ty, tx, co), lambda t, s: (t, s, 0)),
        out_shape=jax.ShapeDtypeStruct((h, wdt, co), x.dtype),
        scratch_shapes=[
            pltpu.VMEM((ty + 2, tx, c), x.dtype),
            pltpu.VMEM((ty + 2, tx, c), x.dtype),
            pltpu.VMEM((ty + 2, tx, c), x.dtype),
            pltpu.SemaphoreType.DMA,
            pltpu.SemaphoreType.DMA,
            pltpu.SemaphoreType.DMA,
        ],
        interpret=True,
    )(xp, w)


# tools/probe_gather.py:133-146 (prim)
def prim(axis, rows, cols):
    def k(src_ref, idx_ref, out_ref):
        out_ref[:] = jnp.take_along_axis(src_ref[:], idx_ref[:],
                                         axis=axis)

    return lambda s, i: pl.pallas_call(
        k, out_shape=jax.ShapeDtypeStruct((rows, cols), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(s, i)


# tools/probe_gather.py:155-167 (prim_roll)
def prim_roll(rows, cols):
    def k(src_ref, s_ref, out_ref):
        out_ref[:] = pltpu.roll(src_ref[:], s_ref[0, 0], axis=1)

    return lambda a, b: pl.pallas_call(
        k, out_shape=jax.ShapeDtypeStruct((rows, cols), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec((1, 1), memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(a, b)


def _bf16(a):
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)
    return t.float().numpy(), t


def test_tile_copy_matches_dma_copy():
    rng = np.random.default_rng(0)
    x, xt = _bf16(rng.standard_normal((16, 24, 51)))
    want = np.asarray(dma_copy(jnp.asarray(x, jnp.bfloat16), 4), np.float32)
    got = tile_copy(xt, 4)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(want, x)


# the kernels' edge cases (probe_gather.EDGE_CASES), which phase 16 of
# chip_smoke.py holds on the card; their indices include -1, rows + cols and
# -(rows + cols), as phase 16's do
EDGE_GATHERS = [pytest.param(*c[1:], True, id=f"axis{c[1]}-{c[2]}x{c[3]}")
                for c in probe_gather.EDGE_CASES if c[0] == "gather"]
EDGE_ROLLS = [pytest.param(*c[1:], id=f"{c[1]}x{c[2]}-shift{c[3]}")
              for c in probe_gather.EDGE_CASES if c[0] == "roll"]


@pytest.mark.parametrize("axis,rows,cols,inject", [
    pytest.param(0, 8, 128, False, id="0"),
    pytest.param(1, 8, 128, False, id="1")] + EDGE_GATHERS)
def test_take_along_axis_matches_prim(axis, rows, cols, inject):
    rng = np.random.default_rng(axis)
    src = rng.random((rows, cols)).astype(np.float32)
    idx = rng.integers(0, rows if axis == 0 else cols, (rows, cols)).astype(
        np.int32)
    if inject:
        idx[0, :3] = [-1, rows + cols, -(rows + cols)]
    want = np.asarray(prim(axis, rows, cols)(jnp.asarray(src),
                                              jnp.asarray(idx)))
    got = take_along_axis(torch.from_numpy(src), torch.from_numpy(idx), axis)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isnan(want).sum() == (2 if inject else 0)


def test_take_along_axis_index_modes_match_jnp():
    """jnp.take_along_axis's default fill mode: a negative index counts from
    the end, one out of range gives NaN; the port's does the same."""
    src = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    idx = torch.tensor([[0, 5, 1, -1], [-4, -5, 3, 4], [2, 2, 0, 0]],
                       dtype=torch.int32)
    got = take_along_axis(src, idx, 1).numpy()
    want = np.asarray(jnp.take_along_axis(jnp.asarray(src.numpy()),
                                          jnp.asarray(idx.numpy()), axis=1))
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got).sum() == 3 and got[0, 3] == 3.0


@pytest.mark.parametrize("rows,cols,shift", [
    pytest.param(8, 128, 17, id="17"), pytest.param(8, 128, -3, id="-3"),
    pytest.param(8, 128, 130, id="130")] + EDGE_ROLLS)
def test_roll_dynamic_matches_prim_roll(rows, cols, shift):
    src = np.random.default_rng(5).random((rows, cols)).astype(np.float32)
    want = np.asarray(prim_roll(rows, cols)(
        jnp.asarray(src), jnp.asarray([[shift]], jnp.int32)))
    np.testing.assert_array_equal(want, np.roll(src, shift, axis=1))
    got = roll_dynamic(torch.from_numpy(src),
                       torch.tensor([shift], dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)


def test_conv3x3_identity_affine_matches_pallas_conv():
    """The conv probe at 128 -> 128 channels: the conv kernel with no
    activation and an identity affine against the 9-shifted-dot kernel."""
    rng = np.random.default_rng(7)
    h, w, c = 16, 32, 128
    x, xt = _bf16(rng.standard_normal((h, w, c)))
    wk, wt = _bf16(rng.standard_normal((3, 3, c, c)) / (3 * c))
    want = np.asarray(pallas_conv(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(wk, jnp.bfloat16), tx=w),
                      np.float32)
    got = conv3x3_fused(xt[None], wt, *fold_affine(c), None)[0].float().numpy()
    err = np.abs(got - want)
    ulp = np.exp2(np.floor(np.log2(np.maximum(
        np.maximum(np.abs(got), np.abs(want)), 2.0 ** -126))) - 7)
    assert (err <= ulp + 2.0 ** -14 * np.abs(want).max()).all(), err.max()


def test_probe_entry_points_on_the_cpu(capsys):
    """Each tool's entry point runs on the CPU when asked, at small shapes:
    the copies are exact, the warp parity cases agree, the timings are
    numbers."""
    copies = probe_dma_conv.copy_probe(
        "cpu", (("tiny", (8, 12, 51)), ("planar", (8, 16, 16))), iters=1)
    assert all(r["correct"] and r["ms"] > 0 for r in copies)
    (conv,) = probe_dma_conv.conv_probe("cpu", ((128, 128, 16),), iters=1)
    assert 0 <= conv["max_err"] < 0.05
    ok, errs = probe_gather.parity("cpu", size=32)
    assert ok and set(errs) == {"fold_flow2", "uniform_pm3", "uniform_pm40",
                                "far_oob", "integer_flow"}
    times = micro_bench.sepconv_bench("cpu", size=16, iters=1, k=5)
    assert set(times) == {"kernel only", "incl prep"}
    assert "correct=True" in capsys.readouterr().out


def test_probe_refusals():
    with pytest.raises(SystemExit):
        micro_bench.main(["--which", "conv", "--device", "cpu"])
    with pytest.raises(ValueError, match="axis"):
        take_along_axis(torch.zeros(2, 2), torch.zeros(2, 2, dtype=torch.int32),
                        2)
    with pytest.raises(TypeError):
        take_along_axis(torch.zeros(2, 2), torch.zeros(2, 2), 0)
    with pytest.raises(ValueError, match="one-element"):
        roll_dynamic(torch.zeros(2, 2), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        tile_copy(torch.zeros(4, 4, device="meta"))
