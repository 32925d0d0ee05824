"""GPU micro-probes (counterparts of the JAX package's ``tools/``):

  probe_dma_conv  tile-copy bandwidth through shared memory, and the conv3x3
                  kernel against the library conv at C 32, 64 and 128
  probe_gather    the gather and dynamic-shift roll primitives, and the
                  serving warp's parity and time
  micro_bench     the sepconv forward with and without its input prep

Each runs as ``python -m sstem_tpu_torch.tools.<probe>``, on the card unless
``--device cpu`` is given.
"""
