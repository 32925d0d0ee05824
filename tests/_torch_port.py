"""Shared weights for the port's parity tests (tests/test_torch_*.py).

``flax .init`` of the three SFF models costs about 35 s of XLA compilation on
a CPU, so the tests take the variable tree from ``jax.eval_shape`` of
``.init`` (a trace, no compile) and fill it from a numpy seed. The same
numpy arrays then go to the flax model and, through
``sstem_tpu_torch.compat.weights``, to the port.
"""

import jax
import jax.numpy as jnp
import numpy as np

from sstem_tpu.models import FusionNet, IFNet, UNetSFF


def numpy_variables(model, seed, shape=(1, 64, 64, 6), **init_kw):
    """The variable tree of ``model.init`` filled from ``seed``.

    Conv kernels are He-uniform (variance 2/fan_in), conv biases U(+-0.05);
    BN weight 1 + N(0, 0.1), bias N(0, 0.1), running mean N(0, 0.1) and
    running var U(0.5, 1.5), so eval-mode BN does real work.
    """
    tree = jax.eval_shape(lambda k, x: model.init(k, x, **init_kw),
                          jax.random.PRNGKey(0), jnp.zeros(shape, jnp.float32))
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


def sff_variables(kernel_size, seed=0):
    """(interp, flow, fusion) variables for IFNet(kernel_size), FusionNet
    and UNetSFF.

    The kernel heads' last conv is scaled so each frame's taps sum to about
    1/sqrt(2) per map, as a trained KPN's do: the interp (the sum of the two
    frames' sepconvs) then stays mostly inside 0..1 instead of saturating.
    """
    iv = numpy_variables(IFNet(kernel_size, 1), seed)
    for head in ("head1h", "head1v", "head2h", "head2v"):
        conv3 = iv["params"][head]["conv3"]["Conv_0"]
        conv3["kernel"] = conv3["kernel"] * np.float32(0.02)
        conv3["bias"] = conv3["bias"] * np.float32(0.2) + np.float32(
            1.0 / (kernel_size * np.sqrt(2.0)))
    return (iv,
            numpy_variables(FusionNet(output_nc=2), seed + 1, train=True),
            numpy_variables(UNetSFF(1), seed + 2, train=True))
