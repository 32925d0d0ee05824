"""The port's SFF restore (sstem_tpu_torch/infer/pipeline.py) vs the JAX
``SFFPipeline(packed_conv=False)`` at K=5, on the same seeded numpy weights
(tests/_torch_port.py) and the same synthetic stacks.

Bounds, for float32 on both sides: interp, fused and warped within 1 uint8
level (floor quantization turns float32 rounding into at most one level);
stitch within 1 level where both sides' ``warped8 >= 2`` masks agree, with
the masks disagreeing on at most 0.1% of pixels; flow within 1e-3 abs.

The port's fused-conv serving path (``packed_conv=True``, bf16) is held to
the same JAX results: NRMSE below 0.05 of each output's std for interp,
fused, warped and flow, the bound tests/test_serving.py sets between the
JAX package's own packed forwards and its flax modules (bf16 against
float32, one step further removed here).
"""

import numpy as np
import pytest
import torch

from sstem_tpu.data.synthetic import synth_stack
from sstem_tpu.infer.pipeline import SFFPipeline as JaxSFFPipeline
from sstem_tpu_torch.config import SERVING_DTYPE
from sstem_tpu_torch.infer.pipeline import SFFPipeline

from _torch_port import port_sff_models, sff_variables

torch.set_num_threads(1)

K = 5
IDS = [1, 3]


@pytest.fixture(scope="module")
def pipelines():
    """(JAX pipeline, port pipeline) on the same numpy weights."""
    iv, fv, uv = sff_variables(K, seed=30)
    interp, flow, fusion = port_sff_models(K, (iv, fv, uv))
    return (JaxSFFPipeline(interp_vars=iv, flow_vars=fv, fusion_vars=uv,
                           kernel_size=K, packed_conv=False),
            SFFPipeline(interp, flow, fusion, device="cpu"))


def _assert_within_bounds(got, want, levels=("interp", "fused", "warped")):
    assert set(got) == set(want)
    for i in want:
        for k in levels:
            assert got[i][k].dtype == np.uint8
            assert got[i][k].shape == want[i][k].shape, (i, k)
            d = np.abs(got[i][k].astype(np.int32) - want[i][k].astype(np.int32))
            assert d.max() <= 1, (i, k, d.max())
        m_got = got[i]["warped"] >= 2
        m_want = want[i]["warped"] >= 2
        agree = m_got == m_want
        assert 1 - agree.mean() <= 1e-3, (i, 1 - agree.mean())
        d = np.abs(got[i]["stitch"].astype(np.int32)
                   - want[i]["stitch"].astype(np.int32))
        assert d[agree].max() <= 1, (i, d[agree].max())
        np.testing.assert_allclose(got[i]["flow"], want[i]["flow"], rtol=0,
                                   atol=1e-3)


@pytest.fixture(scope="module")
def jax_results(pipelines):
    """JAX results by (hw, method), each computed once. At 32-multiple sizes
    both port methods are held against JAX's ``restore_stack_scanned``: the
    JAX package's two methods agree there to the bounds above (its
    tests/test_infer.py pins <= 1 level). At other sizes the two methods
    differ by design in a right/bottom border band (JAX pipeline.py,
    ``restore_stack_scanned``), so each is held against its own."""
    cache = {}

    def get(hw, method):
        if hw[0] % 32 == 0 and hw[1] % 32 == 0:
            method = "restore_stack_scanned"
        if (hw, method) not in cache:
            cache[hw, method] = getattr(pipelines[0], method)(
                synth_stack(5, *hw, seed=3), IDS)
        return cache[hw, method]

    return get


@pytest.mark.parametrize("method", ["restore_stack_scanned", "restore_stack"])
# (83, 75) pads to (96, 96), so the JAX side reuses the functions it
# compiled for the first case
@pytest.mark.parametrize("hw", [(96, 96), (83, 75)])
def test_port_pipeline_matches_jax(pipelines, jax_results, hw, method):
    got = getattr(pipelines[1], method)(synth_stack(5, *hw, seed=3), IDS)
    _assert_within_bounds(got, jax_results(hw, method))


def test_port_scanned_without_flow_matches_jax(pipelines, jax_results):
    """``want_flow=False``: JAX's keys (no 'flow'), the same images. The JAX
    side reruns the program it compiled for (96, 96)."""
    stack = synth_stack(5, 96, 96, seed=3)
    want = pipelines[0].restore_stack_scanned(stack, IDS, want_flow=False)
    got = pipelines[1].restore_stack_scanned(stack, IDS, want_flow=False)
    assert {i: set(r) for i, r in got.items()} == {
        i: set(r) for i, r in want.items()}
    assert all("flow" not in r for r in got.values())
    full = jax_results((96, 96), "restore_stack_scanned")
    _assert_within_bounds({i: {**r, "flow": full[i]["flow"]}
                           for i, r in got.items()}, full)


def test_port_interpolate_unclipped_matches_jax(pipelines):
    """``clip=False`` returns the network's prediction as JAX does (within
    1e-4 abs, float32); ``clip=True`` is its clamp. One (83, 75) section
    pads to (96, 96), as in ``restore_stack``, so the JAX side reuses the
    interp function it compiled there."""
    stack = synth_stack(5, 83, 75, seed=3)
    prev_, next_ = stack[[0]], stack[[2]]
    want = np.asarray(pipelines[0].interpolate(prev_, next_, clip=False))
    got = pipelines[1].interpolate(prev_, next_, clip=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    clipped = pipelines[1].interpolate(prev_, next_)
    assert torch.equal(clipped, got.clamp(0.0, 1.0))


def test_port_test_pad_matches_jax(pipelines):
    """TEST.pad: a symmetric zero pad around the interp input, then a crop.
    83 + 2*6 and 75 + 2*6 round up to the same 32-multiples as 83 and 75, so
    the JAX side reuses its compiled functions."""
    stack = synth_stack(5, 83, 75, seed=4)
    results = []
    for pipe in pipelines:
        pipe.pad = 6
        try:
            results.append(pipe.restore_stack(stack, IDS))
            if pipe is pipelines[1]:
                with pytest.raises(ValueError, match="TEST.pad"):
                    pipe.restore_stack_scanned(stack, IDS)
        finally:
            pipe.pad = 0
    _assert_within_bounds(results[1], results[0])


@pytest.mark.parametrize("bad", [0, 4])
def test_check_interior_rejects_boundary_sections(pipelines, bad):
    pipe = pipelines[1]
    stack = synth_stack(5, 32, 32, seed=5)
    for method in (pipe.restore_stack, pipe.restore_stack_scanned):
        with pytest.raises(ValueError, match="z-neighbor"):
            method(stack, [2, bad])


def _packed(pipelines, fused_head_tail=False):
    """The port's packed_conv=True pipeline on the float32 pipeline's
    modules (the packed path reads their weights and does not cast them)."""
    p = pipelines[1]
    return SFFPipeline(p.interp_model, p.flow_model, p.fusion_model, "cpu",
                       dtype=SERVING_DTYPE, packed_conv=True,
                       fused_head_tail=fused_head_tail)


def _nrmse_report(got, want, ids):
    """{output: NRMSE of got against want, relative to want's std}; prints
    the largest uint8 level difference and the share of pixels more than 1
    level apart."""
    out = {}
    for key in ("interp", "fused", "warped", "flow"):
        a = np.stack([got[i][key] for i in ids]).astype(np.float64)
        b = np.stack([want[i][key] for i in ids]).astype(np.float64)
        out[key] = float(np.sqrt(np.mean((a - b) ** 2)) / b.std())
        if key != "flow":
            d = np.abs(a - b)
            print(f"{key}: nrmse {out[key]:.4f}, max level diff {d.max():.0f}, "
                  f"share > 1 level {(d > 1).mean():.5f}")
    return out


def test_packed_pipeline_matches_jax(pipelines, jax_results):
    hw = (96, 96)
    got = _packed(pipelines).restore_stack_scanned(synth_stack(5, *hw, seed=3),
                                                   IDS)
    nrmse = _nrmse_report(got, jax_results(hw, "restore_stack_scanned"), IDS)
    assert all(v < 0.05 for v in nrmse.values()), nrmse


def test_packed_fused_head_tail_matches_unfused(pipelines):
    stack = synth_stack(5, 96, 96, seed=3)
    want = _packed(pipelines).restore_stack(stack, IDS)
    got = _packed(pipelines, fused_head_tail=True).restore_stack(stack, IDS)
    nrmse = _nrmse_report(got, want, IDS)
    assert all(v < 0.05 for v in nrmse.values()), nrmse


def test_interp_only_pipeline_matches_jax(pipelines):
    """The interp CLI's configuration: the port's pipeline built with the
    interp model alone, ``interpolate(clip=False)`` held against JAX within
    1e-4 abs (float32) on the section that
    ``test_port_interpolate_unclipped_matches_jax`` uses, so the JAX side
    reuses its compiled interp. The missing stages raise, naming the
    models."""
    interp = pipelines[1].interp_model
    pipe = SFFPipeline(interp, None, None, device="cpu")
    stack = synth_stack(5, 83, 75, seed=3)
    want = np.asarray(pipelines[0].interpolate(stack[[0]], stack[[2]],
                                               clip=False))
    got = pipe.interpolate(stack[[0]], stack[[2]], clip=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="flow_model, fusion_model"):
        pipe.restore(stack[[1]], stack[[1]])
    with pytest.raises(ValueError, match="restore_stack_scanned needs"):
        pipe.restore_stack_scanned(stack, IDS)


def test_flow_fusion_only_pipeline_matches_jax(pipelines):
    """The fusion CLI's configuration: the port's pipeline built with the
    flow and fusion models alone, ``restore`` held against the JAX one
    (float32) on a degraded section and an interp image of 83 x 75, which
    pad to the (96, 96) the JAX side compiled for ``restore_stack``:
    fused, warped and stitch within 1 uint8 level (stitch where both
    ``warped8 >= 2`` masks agree, on all but 0.1% of pixels), flow within
    1e-3 abs."""
    p = pipelines[1]
    pipe = SFFPipeline(None, p.flow_model, p.fusion_model, device="cpu")
    stack = synth_stack(5, 83, 75, seed=6)
    deg, interp = stack[[2]], stack[[1]]
    want = {k: np.asarray(v) for k, v in pipelines[0].restore(deg, interp).items()}
    got = {k: v.numpy() for k, v in pipe.restore(deg, interp).items()}

    def section(d):
        return {0: {"flow": d["flow"][0],
                    **{k: np.floor(d[k][0] * 255).astype(np.uint8)
                       for k in ("fused", "warped", "stitch")}}}

    _assert_within_bounds(section(got), section(want), ("fused", "warped"))
    with pytest.raises(ValueError, match="needs interp_model"):
        pipe.interpolate(stack[[0]], stack[[2]])
