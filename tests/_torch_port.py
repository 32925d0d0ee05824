"""Shared weights for the port's parity tests (tests/test_torch_*.py).

``flax .init`` of the three SFF models costs about 35 s of XLA compilation on
a CPU, so the tests take the variable tree from ``jax.eval_shape`` of
``.init`` (a trace, no compile; about a second, so each tree is traced once
per process) and fill it from a numpy seed. The same numpy arrays then go to
the flax model and, through ``sstem_tpu_torch.compat.weights``, to the port.

The port's IFNet spends a second or two of its constructor on orthogonal
init, which every test overwrites by loading weights; ``port_module`` builds
each port class once per process and hands out copies.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np

from sstem_tpu.models import FusionNet, IFNet, UNetSFF
from sstem_tpu_torch import models as port_models
from sstem_tpu_torch.compat import (
    fusionnet_state_dict_from_jax,
    ifnet_state_dict_from_jax,
    unet_sff_state_dict_from_jax,
)

_TREES = {}  # the traced shape tree by model, input shape and init kwargs
_PORT = {}  # one constructed port module by class name and arguments


def numpy_variables(model, seed, shape=(1, 64, 64, 6), **init_kw):
    """The variable tree of ``model.init`` filled from ``seed``.

    Conv kernels are He-uniform (variance 2/fan_in), conv biases U(+-0.05);
    BN weight 1 + N(0, 0.1), bias N(0, 0.1), running mean N(0, 0.1) and
    running var U(0.5, 1.5), so eval-mode BN does real work.
    """
    key = (repr(model), shape, tuple(sorted(init_kw.items())))
    if key not in _TREES:
        _TREES[key] = jax.eval_shape(
            lambda k, x: model.init(k, x, **init_kw), jax.random.PRNGKey(0),
            jnp.zeros(shape, jnp.float32))
    tree = _TREES[key]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, parent = path[-1].key, path[-2].key
        s = leaf.shape
        if name == "kernel":
            # deconv kernels (kh, kw, out, in) sit directly in their module;
            # conv kernels (kh, kw, in, out) in a Conv_0 child
            fan_in = s[0] * s[1] * (s[2] if parent == "Conv_0" else s[3])
            a = rng.uniform(-1, 1, s) * np.sqrt(6.0 / fan_in)
        elif parent == "BatchNorm_0" and name == "scale":
            a = 1 + rng.normal(0, 0.1, s)
        elif parent == "BatchNorm_0" and name in ("bias", "mean"):
            a = rng.normal(0, 0.1, s)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, s)
        else:  # conv bias
            a = rng.uniform(-0.05, 0.05, s)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def ifnet_variables(kernel_size, seed=0):
    """IFNet(kernel_size) variables whose kernel heads' last conv is scaled
    so each frame's taps sum to about 1/sqrt(2) per map, as a trained KPN's
    do: the interp (the sum of the two frames' sepconvs) then stays mostly
    inside 0..1 instead of saturating."""
    iv = numpy_variables(IFNet(kernel_size, 1), seed)
    for head in ("head1h", "head1v", "head2h", "head2v"):
        conv3 = iv["params"][head]["conv3"]["Conv_0"]
        conv3["kernel"] = conv3["kernel"] * np.float32(0.02)
        conv3["bias"] = conv3["bias"] * np.float32(0.2) + np.float32(
            1.0 / (kernel_size * np.sqrt(2.0)))
    return iv


def sff_variables(kernel_size, seed=0):
    """(interp, flow, fusion) variables for IFNet(kernel_size) (see
    ``ifnet_variables``), FusionNet and UNetSFF."""
    return (ifnet_variables(kernel_size, seed),
            numpy_variables(FusionNet(output_nc=2), seed + 1, train=True),
            numpy_variables(UNetSFF(1), seed + 2, train=True))


def port_module(name, *args):
    """A fresh port module (``IFNet``, ``FusionNet`` or ``UNetSFF`` with
    ``args``), copied from one constructed per process: its initial weights
    are those of a default generator, for the caller to overwrite."""
    key = (name, args)
    if key not in _PORT:
        _PORT[key] = getattr(port_models, name)(*args)
    return copy.deepcopy(_PORT[key])


def port_sff_models(kernel_size, variables):
    """The port's (IFNet, FusionNet, UNetSFF) in eval mode, strictly loaded
    with the flax ``variables`` of ``sff_variables``."""
    iv, fv, uv = variables
    out = []
    for name, args, to_sd, v in (
            ("IFNet", (kernel_size,), ifnet_state_dict_from_jax, iv),
            ("FusionNet", (), fusionnet_state_dict_from_jax, fv),
            ("UNetSFF", (), unet_sff_state_dict_from_jax, uv)):
        model = port_module(name, *args)
        model.load_state_dict(to_sd(v), strict=True)
        out.append(model.eval())
    return tuple(out)
