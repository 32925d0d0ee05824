"""Port models (sstem_tpu_torch/models) and weight carry-over
(sstem_tpu_torch/compat/weights.py) vs the flax models.

Weights are numpy arrays from a seed in the flax variable trees
(tests/_torch_port.py), carried over by ``*_state_dict_from_jax`` and loaded
strictly; both sides then run the same numpy input in eval mode at 64x64.
Tolerance 5e-4 abs, that of tests/test_reference_parity.py, with JAX at
HIGHEST matmul precision.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sstem_tpu.config as jax_cfg
from sstem_tpu.compat.torch_ckpt import (
    load_torch_fusionnet,
    load_torch_ifnet,
    load_torch_unet_sff,
)
from sstem_tpu.models import FusionNet as JaxFusionNet
from sstem_tpu.models import IFNet as JaxIFNet
from sstem_tpu.models import UNetSFF as JaxUNetSFF
from sstem_tpu_torch.compat import (
    fusionnet_state_dict_from_jax,
    ifnet_state_dict_from_jax,
    load_reference,
    unet_sff_state_dict_from_jax,
)
from sstem_tpu_torch.models import FusionNet, UNetSFF
from sstem_tpu_torch.models.layers import set_compute_dtype

from _torch_port import port_module, sff_variables

torch.set_num_threads(1)

TOL = 5e-4
K = 5

MODELS = {
    # name: (flax module, port class, state-dict converter, JAX importer,
    #        apply kwargs)
    "ifnet": (JaxIFNet(kernel_size=K, n_frames=1), lambda: port_module("IFNet", K),
              ifnet_state_dict_from_jax, load_torch_ifnet, {}),
    "fusionnet": (JaxFusionNet(output_nc=2), lambda: port_module("FusionNet"),
                  fusionnet_state_dict_from_jax, load_torch_fusionnet,
                  {"train": False}),
    "unet_sff": (JaxUNetSFF(out_channel=1), lambda: port_module("UNetSFF"),
                 unet_sff_state_dict_from_jax, load_torch_unet_sff,
                 {"train": False}),
}


@pytest.fixture(scope="module")
def jax_side():
    """{name: (variables, input (2, 64, 64, 6), flax output)}."""
    prev = jax_cfg.matmul_precision()
    jax_cfg.set_matmul_precision("highest")
    try:
        x = np.random.default_rng(21).random((2, 64, 64, 6), dtype=np.float32)
        out = {}
        for name, variables in zip(MODELS, sff_variables(K, seed=20)):
            model, kw = MODELS[name][0], MODELS[name][4]
            y = jax.jit(lambda v, xx: model.apply(v, xx, **kw))(
                variables, jnp.asarray(x))
            out[name] = (variables, x, np.asarray(y))
        yield out
    finally:
        jax_cfg.set_matmul_precision(prev.name.lower())


@pytest.fixture(scope="module")
def port_models(jax_side):
    """{name: port model with the JAX side's weights, strictly loaded}."""
    models = {}
    for name, (_, make, to_sd, _, _) in MODELS.items():
        models[name] = make()
        models[name].load_state_dict(to_sd(jax_side[name][0]), strict=True)
        models[name].eval()
    return models


@pytest.mark.parametrize("name", sorted(MODELS))
def test_port_model_matches_flax(jax_side, port_models, name):
    _, x, want = jax_side[name]
    model = port_models[name]
    with torch.inference_mode():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    got = got.numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def _assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), path
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and np.array_equal(x, y), f"{path}/{k}"


@pytest.mark.parametrize("name", sorted(MODELS))
def test_jax_vars_round_trip_through_port_state_dict(jax_side, port_models,
                                                    name):
    """JAX vars -> port state dict -> strict load -> state_dict() -> the JAX
    package's reference-checkpoint importer gives the JAX vars back."""
    back = MODELS[name][3](port_models[name].state_dict())
    _assert_trees_equal(back, jax_side[name][0])


def test_reference_checkpoint_loads_with_module_prefix():
    """A reference payload ({'model_weights': DataParallel state dict}, with
    the vestigial SR branch and without BN counters) loads strictly."""
    src = UNetSFF(generator=torch.Generator().manual_seed(3))
    weights = {f"module.{k}": v for k, v in src.state_dict().items()
               if not k.endswith("num_batches_tracked")}
    weights["module.srconv1.weight"] = torch.zeros(1)
    dst = load_reference(UNetSFF(), {"model_weights": weights, "current_iter": 7})
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k


def test_init_uses_only_the_given_generator():
    state = torch.random.get_rng_state()
    a = FusionNet(generator=torch.Generator().manual_seed(5))
    b = FusionNet(generator=torch.Generator().manual_seed(5))
    assert torch.equal(torch.random.get_rng_state(), state)
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    bn = a.down_1.conv_1[1].weight.detach()
    assert 0.9 < float(bn.min()) and float(bn.max()) < 1.1  # normal(1, 0.02)


def test_bf16_compute_keeps_batchnorm_in_float32():
    model = FusionNet(generator=torch.Generator().manual_seed(4)).eval()
    x = torch.rand(1, 6, 32, 32, generator=torch.Generator().manual_seed(6))
    with torch.inference_mode():
        want = model(x)
        set_compute_dtype(model, torch.bfloat16)
        got = model(x)
    assert model.down_1.conv_1[0].weight.dtype == torch.bfloat16
    assert model.down_1.conv_1[1].weight.dtype == torch.float32
    assert got.dtype == torch.bfloat16
    err = float((got.float() - want).abs().max())
    assert 0 < err < 0.05 * float(want.abs().max())
