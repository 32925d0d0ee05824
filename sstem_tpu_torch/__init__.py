"""sstem_tpu_torch — the PyTorch and CUDA port of ``sstem_tpu``.

The JAX package ``sstem_tpu`` is the reference; this package computes the
same functions in PyTorch, with hand-written CUDA kernels for Hopper
(``sm_90a``) in place of the Pallas TPU kernels. Module names mirror
``sstem_tpu`` so each counterpart is easy to find:

  config.py   compute dtype and the TF32 policy
  ops/        replication pad, align-corners resize, zero-border warp, fold flows
  kernels/    sepconv and warp wrappers (CUDA kernel on the card, plain torch on
              the CPU) and the nvcc/ctypes build of ``csrc/*.cu``
  models/     IFNet, FusionNet, UNetSFF in NCHW with the reference's key names
  compat/     JAX variables and reference checkpoints -> port state dicts
  infer/      the SFF restore pipeline and pad-to-stride
  data/       synthetic ssTEM stacks

This package imports torch, numpy and scipy, and never jax or sstem_tpu.
"""

__version__ = "0.1.0"
