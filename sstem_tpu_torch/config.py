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

The compute-dtype policy, with the JAX package's names
(``set_compute_dtype``; ``None`` is the default): under ``"bfloat16"``
every ``models/layers`` conv whose weights are float32 casts its input,
weight and bias to bf16 inside autograd and returns bf16, as JAX's
``Conv2dTorch`` and ``ConvTranspose2dTorch`` do, so the activations
between convs are bf16 while the parameters, their gradients, the
optimizer state and the checkpoints stay float32; BatchNorm computes its
statistics in float32 and emits its input's dtype; IFNet pads its frames
in bf16, so both sepconvs run on bf16 frames and bf16 tap maps. A loss
of a bf16 prediction against a float32 target promotes to float32.
VGG19 and the discriminators keep float32, as the JAX package's plain
flax convs promote a bf16 input to their float32 parameters.

The policy, the pipelines' ``dtype=`` and the precision compose so:

  * a module whose conv weights are bf16 (``layers.cast_conv_weights``;
    ``SFFPipeline(dtype=SERVING_DTYPE)`` and ``SPPipeline``'s bf16 path
    cast theirs) runs in bf16 whatever the policy says, and the fused-conv
    serving forwards do not read it;
  * a float32 module follows the policy: under ``"bfloat16"`` its convs
    run bf16 and return bf16, whatever the matmul precision (cuDNN
    accumulates a bf16 conv in float32 at every one), which overrides the
    ``"default"`` precision's single bf16 pass with its float32 result;
    under ``None`` the precision alone decides;
  * the pipelines' ``dtype=`` keeps its meaning: ``PARITY_DTYPE``
    (float32) leaves the weights float32, so such a pipeline follows the
    policy; ``SERVING_DTYPE`` (bfloat16) casts the conv weights.

Entry points apply the precision and leave the compute dtype as the
caller set it; a fresh process starts at ``None`` (float32 activations).
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


_COMPUTE_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}
# the layers and IFNet read this once per forward: None (float32
# activations) or torch.bfloat16
COMPUTE_DTYPE = None


def set_compute_dtype(name):
    """Set the activation dtype of float32 convs: ``None`` or ``"float32"``
    (float32), or ``"bfloat16"``; another name raises KeyError."""
    global COMPUTE_DTYPE
    COMPUTE_DTYPE = _COMPUTE_DTYPES[name]


def compute_dtype():
    """``None`` (float32 activations) or ``torch.bfloat16``."""
    return COMPUTE_DTYPE


def disable_tf32():
    """Run float32 convolutions and matmuls in full float32 on the card:
    ``set_matmul_precision("highest")``."""
    set_matmul_precision("highest")
