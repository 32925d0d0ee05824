"""sstem_tpu_torch — the PyTorch and CUDA port of ``sstem_tpu``.

The JAX package ``sstem_tpu`` is the reference; this package computes the
same functions in PyTorch, with hand-written CUDA kernels for Hopper
(``sm_90a``) in place of the Pallas TPU kernels. Module names mirror
``sstem_tpu`` so each counterpart is easy to find:

  config.py   compute dtype and the TF32 policy
  ops/        replication pad and the loss crop, align-corners resize, the
              zero-border and edge-clamped warps, fold flows (numpy and
              batched torch), the Middlebury flow rendering
  kernels/    sepconv (forward and backward), warp, conv3x3, pool, deconv and
              head-tail wrappers (CUDA kernel on the card, plain torch on the
              CPU) and the nvcc/ctypes build of ``csrc/*.cu``
  models/     IFNet, FusionNet, UNetSFF in NCHW with the reference's key names;
              ``serving.py``, their fused-conv bf16 serving forwards
  compat/     JAX variables and reference checkpoints -> port state dicts;
              the reference's YAML configs
  infer/      the SFF and SP restore pipelines (the SFF one also sharded over
              a mesh), pad-to-stride, one-shot and tiled inference
  parallel/   device meshes, batch sharding, replicas, row sharding with
              halo exchange (one process; data moves as tensor copies)
  utils/      debug tools: non-finite checks, profiler traces, step timers
  data/       synthetic ssTEM stacks and triplet trees, augmentations, the
              SFF fold degradation (host and batched on the device), the
              interp, unfolding and fusion datasets, the threaded provider
  losses.py   L1, L2, SSIM, the flow EPE family; metrics.py: reference PSNR
              and SSIM
  train/      optimizer, train step, LR schedule, checkpoints, the loop, the
              degradation and crop sampling inside the step
  cli/        ``python -m sstem_tpu_torch.cli.<name>``: train_interp,
              train_unfolding, train_fusion, infer_interp,
              infer_interp_single, infer_interp_trainingset,
              infer_unfolding, infer_fusion, test_sp_interp, test_sp_fusion

This package imports torch, numpy and scipy, and never jax or sstem_tpu.
"""

__version__ = "0.1.0"
