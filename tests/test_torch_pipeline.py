"""The port's SFF restore (sstem_tpu_torch/infer/pipeline.py) vs the JAX
``SFFPipeline(packed_conv=False)`` at K=5, on the same seeded numpy weights
(tests/_torch_port.py) and the same synthetic stacks.

Bounds, for float32 on both sides: interp, fused and warped within 1 uint8
level (floor quantization turns float32 rounding into at most one level);
stitch within 1 level where both sides' ``warped8 >= 2`` masks agree, with
the masks disagreeing on at most 0.1% of pixels; flow within 1e-3 abs.
"""

import numpy as np
import pytest
import torch

from sstem_tpu.data.synthetic import synth_stack
from sstem_tpu.infer.pipeline import SFFPipeline as JaxSFFPipeline
from sstem_tpu_torch.compat import (
    fusionnet_state_dict_from_jax,
    ifnet_state_dict_from_jax,
    unet_sff_state_dict_from_jax,
)
from sstem_tpu_torch.infer.pipeline import SFFPipeline
from sstem_tpu_torch.models import FusionNet, IFNet, UNetSFF

from _torch_port import sff_variables

torch.set_num_threads(1)

K = 5
IDS = [1, 3]


@pytest.fixture(scope="module")
def pipelines():
    """(JAX pipeline, port pipeline) on the same numpy weights."""
    iv, fv, uv = sff_variables(K, seed=30)
    interp = IFNet(K)
    interp.load_state_dict(ifnet_state_dict_from_jax(iv), strict=True)
    flow = FusionNet()
    flow.load_state_dict(fusionnet_state_dict_from_jax(fv), strict=True)
    fusion = UNetSFF()
    fusion.load_state_dict(unet_sff_state_dict_from_jax(uv), strict=True)
    return (JaxSFFPipeline(interp_vars=iv, flow_vars=fv, fusion_vars=uv,
                           kernel_size=K, packed_conv=False),
            SFFPipeline(interp, flow, fusion, device="cpu"))


def _assert_within_bounds(got, want):
    assert set(got) == set(want)
    for i in want:
        for k in ("interp", "fused", "warped"):
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
@pytest.mark.parametrize("hw", [(96, 96), (83, 101)])
def test_port_pipeline_matches_jax(pipelines, jax_results, hw, method):
    got = getattr(pipelines[1], method)(synth_stack(5, *hw, seed=3), IDS)
    _assert_within_bounds(got, jax_results(hw, method))


def test_port_test_pad_matches_jax(pipelines):
    """TEST.pad: a symmetric zero pad around the interp input, then a crop.
    83 + 2*6 rounds up to the same 32-multiple as 83, so the JAX side reuses
    its compiled functions."""
    stack = synth_stack(5, 83, 101, seed=4)
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
