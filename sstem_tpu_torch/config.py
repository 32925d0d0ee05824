"""Numerical policy of the port (counterpart of ``sstem_tpu/config.py``).

The matmul-precision policy, with the JAX package's three names
(``set_matmul_precision``; ``"highest"`` is the default). On the card each
name means:

  * ``"highest"`` — IEEE float32: TF32 off for cuDNN convolutions and for
    matmuls (the parity and quality setting).
  * ``"high"`` — TF32 for cuDNN convolutions and for matmuls (PyTorch's own
    ``"high"`` level puts TF32 and bf16x3 in one class).
  * ``"default"`` — single-pass bf16 inputs with float32 accumulation, as
    the MXU computes ``Precision.DEFAULT``: ``models/layers.Conv2d`` and
    ``ConvTranspose2d`` with float32 weights cast their input and weight to
    bf16 and return float32 (the bias is added in float32), and so do the
    VGG19 convolutions (built from those layers) and the SSIM window
    convolution of ``losses.py``, where JAX reads the policy too. The casts
    sit inside autograd, so the backward convolutions run in bf16 as well.
    Matmuls run at torch's ``"medium"``; any other float32 cuDNN
    convolution runs in TF32. BatchNorm stays float32, as in JAX.

PyTorch itself starts with ``torch.backends.cudnn.allow_tf32`` True, which
keeps about three decimal digits in float32 convolutions. Every entry point
of the port (the CLIs' ``main``, the pipelines' constructors, ``infer_full``
and ``infer_tiled``, the dry run and a spawned rank) therefore calls
``apply_matmul_precision()`` first, which pushes the current policy into
torch's flags: a fresh process computes float32 at ``"highest"`` unless its
caller set a lower policy before.

Two compute dtypes exist, as in the JAX package:

  * ``PARITY_DTYPE`` (float32) — parity and quality work, under the policy.
  * ``SERVING_DTYPE`` (bfloat16) — serving. Convolution weights and
    activations are bf16; BatchNorm computes in float32 and emits bf16
    (``models/layers.py``); the sepconv kernel accumulates in float32. A
    module cast to bf16 and the fused-conv serving forwards do not read the
    policy.

The dtype is not global state: callers pass it to ``SFFPipeline``.
"""

import torch

PARITY_DTYPE = torch.float32
SERVING_DTYPE = torch.bfloat16

# name -> torch.set_float32_matmul_precision level
_MATMUL_LEVELS = {"highest": "highest", "high": "high", "default": "medium"}

_PRECISION = "highest"
# the layers read this flag once per forward: the "default" policy's
# single-pass bf16 convolutions
BF16_PASS = False


def set_matmul_precision(name: str):
    """Set the policy (``"highest"``, ``"high"`` or ``"default"``; another
    name raises KeyError) and apply it to torch's flags."""
    global _PRECISION, BF16_PASS
    _MATMUL_LEVELS[name]
    _PRECISION = name
    BF16_PASS = name == "default"
    apply_matmul_precision()


def matmul_precision():
    return _PRECISION


def apply_matmul_precision():
    """Push the current policy into torch's process flags: cuDNN's and the
    matmuls' TF32 switches and the float32 matmul precision."""
    # the level sets torch.backends.cuda.matmul.allow_tf32 too (False at
    # "highest"); setting that flag again after "medium" would raise it to
    # "high" and leave torch's two precision APIs disagreeing
    torch.set_float32_matmul_precision(_MATMUL_LEVELS[_PRECISION])
    torch.backends.cudnn.allow_tf32 = _PRECISION != "highest"


def disable_tf32():
    """Run float32 convolutions and matmuls in full float32 on the card:
    ``set_matmul_precision("highest")``."""
    set_matmul_precision("highest")
