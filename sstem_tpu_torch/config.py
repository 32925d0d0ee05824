"""Numerical policy of the port (counterpart of ``sstem_tpu/config.py``).

Two compute dtypes exist, as in the JAX package:

  * ``PARITY_DTYPE`` (float32) — parity and quality work. PyTorch runs
    float32 cuDNN convolutions in TF32 by default
    (``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
    decimal digits; every float32 parity run calls ``disable_tf32()`` first.
  * ``SERVING_DTYPE`` (bfloat16) — serving. Convolution weights and
    activations are bf16; BatchNorm computes in float32 and emits bf16
    (``models/layers.py``); the sepconv kernel accumulates in float32.

The dtype is not global state: callers pass it to ``SFFPipeline``.
"""

import torch

PARITY_DTYPE = torch.float32
SERVING_DTYPE = torch.bfloat16


def disable_tf32():
    """Run float32 convolutions and matmuls in full float32 on the card."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
