"""sstem_tpu_torch — the PyTorch and CUDA port of ``sstem_tpu``.

The JAX package ``sstem_tpu`` is the reference; this package computes the
same functions in PyTorch, with hand-written CUDA kernels for Hopper
(``sm_90a``) in place of the Pallas TPU kernels. Module names mirror
``sstem_tpu`` so each counterpart is easy to find:

  config.py   compute dtype and the TF32 policy
  ops/        replication pad, align-corners resize, zero-border warp, fold
              flows, the Middlebury flow rendering
  kernels/    sepconv (forward and backward), warp, conv3x3, pool, deconv and
              head-tail wrappers (CUDA kernel on the card, plain torch on the
              CPU) and the nvcc/ctypes build of ``csrc/*.cu``
  models/     IFNet, FusionNet, UNetSFF in NCHW with the reference's key names;
              ``serving.py``, their fused-conv bf16 serving forwards
  compat/     JAX variables and reference checkpoints -> port state dicts;
              the reference's YAML configs
  infer/      the SFF and SP restore pipelines and pad-to-stride
  data/       synthetic ssTEM stacks and triplet trees, augmentations, the
              interp datasets and the threaded provider
  losses.py   L1, L2, SSIM; metrics.py: reference PSNR and SSIM
  train/      optimizer, train step, LR schedule, checkpoints, the loop
  cli/        ``python -m sstem_tpu_torch.cli.<name>``: train_interp,
              infer_interp, infer_fusion, test_sp_interp, test_sp_fusion

This package imports torch, numpy and scipy, and never jax or sstem_tpu.
"""

__version__ = "0.1.0"
