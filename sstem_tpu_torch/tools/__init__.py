"""GPU tools (counterparts of the JAX package's ``tools/``):

  probe_dma_conv      tile-copy bandwidth through shared memory, and the
                      conv3x3 kernel against the library conv at C 32, 64
                      and 128
  probe_gather        the gather and dynamic-shift roll primitives, and the
                      serving warp's parity and time
  micro_bench         the sepconv forward with and without its input prep
  gpu_checks          the correctness gate: every kernel against its plain
                      version at the JAX gate's cases (GPU_CHECKS.json)
  profile_pipeline    the SFF nets' module forwards by stage
  profile_serve       the packed serving path by piece
  profile_fine        the module restore path by stage at the bench's batch
  ifnet_prefix_bench  IFNet's forward cut at its stages
  micro_conv_bench    the library conv, deconv, pool and BatchNorm pieces
  bench_conv3x3       the conv3x3 kernel against the library conv
  verify_drive        the end-to-end drive: restores card against CPU, a
                      training step
  quality_run, quality_run_sp, quality_check, diagnose_fusion
                      the self-trained quality runs and their reports

Each runs as ``python -m sstem_tpu_torch.tools.<tool>``, on the card; the
probes and profilers run on the CPU only when given ``--device cpu``, and
the on-card tools exit 2 without a card.
"""
