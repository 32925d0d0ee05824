from sstem_tpu_torch.data.synthetic import synth_stack, write_triplet_tree

__all__ = ["synth_stack", "write_triplet_tree"]
