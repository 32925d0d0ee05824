"""Shared weights for the port's parity tests (tests/test_torch_*.py).

``flax .init`` of the three SFF models costs about 35 s of XLA compilation on
a CPU (the SP models likewise), so the tests take the variable tree from the
JAX package's importer of the port twin's state dict
(``sstem_tpu.compat.torch_ckpt``; ``jax.eval_shape`` of ``.init``, a trace
of about a second, for a model without a twin) and fill it from a numpy
seed. The same numpy arrays then go to
the flax model and, through ``sstem_tpu_torch.compat.weights``, to the port.

The port's IFNet spends a second or two of its constructor on orthogonal
init; ``port_module`` builds each port class once per process and hands out
copies, and with ``empty=True`` (for a caller that loads every value next,
as ``port_sff_models`` and ``port_sp_models`` do) draws no initial values.
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np

from sstem_tpu.compat.torch_ckpt import (
    load_torch_fusionnet,
    load_torch_ifnet,
    load_torch_unet_sff,
    load_torch_unet_sp,
)
from sstem_tpu.models import FusionNet, IFNet, UNetSFF, UNetSP
from sstem_tpu_torch import models as port_models
from sstem_tpu_torch.compat import (
    fusionnet_state_dict_from_jax,
    ifnet_state_dict_from_jax,
    unet_sff_state_dict_from_jax,
    unet_sp_state_dict_from_jax,
)
from sstem_tpu_torch.models.layers import skip_init

_TREES = {}  # the variable tree by model, input shape and init kwargs
_PORT = {}  # one constructed port module by class name and arguments

# flax model class -> (its port twin built for it and an input shape, the
# JAX package's importer of the twin's state dict)
_TWINS = {
    IFNet: (lambda m, shape: port_module("IFNet", m.kernel_size, m.n_frames,
                                         empty=True),
            lambda m, sd: load_torch_ifnet(sd, m.n_frames)),
    FusionNet: (lambda m, shape: port_module("FusionNet", shape[-1],
                                             m.output_nc, m.ngf, empty=True),
                lambda m, sd: load_torch_fusionnet(sd)),
    UNetSFF: (lambda m, shape: port_module("UNetSFF", shape[-1], m.out_channel,
                                           empty=True),
              lambda m, sd: load_torch_unet_sff(sd)),
    UNetSP: (lambda m, shape: port_module("UNetSP", m.n_classes, empty=True),
             lambda m, sd: load_torch_unet_sp(sd)),
}


def _variable_tree(model, shape, init_kw):
    """The shapes of ``model.init``'s variables. For the four models with a
    port twin, the JAX importer's tree of the twin's state dict: no trace,
    the same paths in the same order (flax's ``apply`` rejects a tree that
    misses a variable or changes a shape); else ``jax.eval_shape`` of
    ``.init`` (a trace of about a second)."""
    if type(model) in _TWINS:
        build, load = _TWINS[type(model)]
        return load(model, build(model, shape).state_dict())
    return jax.eval_shape(
        lambda k, x: model.init(k, x, **init_kw), jax.random.PRNGKey(0),
        jnp.zeros(shape, jnp.float32))


def numpy_variables(model, seed, shape=(1, 64, 64, 6), **init_kw):
    """The variable tree of ``model.init`` filled from ``seed``.

    Conv kernels are He-uniform (variance 2/fan_in), conv biases U(+-0.05);
    BN weight 1 + N(0, 0.1), bias N(0, 0.1), running mean N(0, 0.1) and
    running var U(0.5, 1.5), so eval-mode BN does real work.
    """
    key = (repr(model), shape, tuple(sorted(init_kw.items())))
    if key not in _TREES:
        _TREES[key] = _variable_tree(model, shape, init_kw)
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


def ifnet_variables(kernel_size, seed=0, n_frames=1):
    """IFNet(kernel_size, n_frames) variables whose kernel heads' last conv
    is scaled so each frame's taps sum to about 1/sqrt(2) per map, as a
    trained KPN's do: the interp (the sum of the two frames' sepconvs) then
    stays mostly inside 0..1 instead of saturating."""
    iv = numpy_variables(IFNet(kernel_size, n_frames), seed)
    for head in [k for k in iv["params"] if k.startswith("head")]:
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


def sp_variables(kernel_size, seed=0):
    """(vfi, denoise, fusion) variables for IFNet(kernel_size, n_frames=2)
    (see ``ifnet_variables``), UNetSP and FusionNetSP. The two U-Nets have
    the same variable tree, so FusionNetSP's is UNetSP's, filled from its
    own seed."""
    tree = UNetSP(1)
    return (ifnet_variables(kernel_size, seed, n_frames=2),
            numpy_variables(tree, seed + 1, (1, 64, 64, 1), train=True),
            numpy_variables(tree, seed + 2, (1, 64, 64, 1), train=True))


def port_sp_models(kernel_size, variables):
    """The port's (IFNet(n_frames=2), UNetSP, FusionNetSP) in eval mode,
    strictly loaded with the flax ``variables`` of ``sp_variables``."""
    iv, dv, fv = variables
    out = []
    for name, args, sd in (
            ("IFNet", (kernel_size, 2), ifnet_state_dict_from_jax(iv, 2)),
            ("UNetSP", (), unet_sp_state_dict_from_jax(dv)),
            ("FusionNetSP", (), unet_sp_state_dict_from_jax(fv))):
        model = port_module(name, *args, empty=True)
        model.load_state_dict(sd, strict=True)
        out.append(model.eval())
    return tuple(out)


def port_module(name, *args, empty=False):
    """A fresh port module (``IFNet``, ``FusionNet``, ``UNetSFF``, ``UNetSP``
    or ``FusionNetSP`` with ``args``), copied from one constructed per
    process: its initial weights are those of a default generator, or, with
    ``empty``, none (built under ``skip_init``, for a caller that loads a
    full state dict strictly next)."""
    key = (name, args, empty)
    if key not in _PORT:
        with skip_init() if empty else contextlib.nullcontext():
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
        model = port_module(name, *args, empty=True)
        model.load_state_dict(to_sd(v), strict=True)
        out.append(model.eval())
    return tuple(out)
