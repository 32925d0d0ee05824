from sstem_tpu_torch.data.synthetic import (
    synth_blob_mask, synth_stack, write_triplet_tree,
)

__all__ = ["synth_blob_mask", "synth_stack", "write_triplet_tree"]
