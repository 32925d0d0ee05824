from sstem_tpu_torch.data.synthetic import synth_stack

__all__ = ["synth_stack"]
