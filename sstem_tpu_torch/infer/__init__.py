from sstem_tpu_torch.infer.tiles import pad_to_multiple
from sstem_tpu_torch.infer.pipeline import SFFPipeline, SPPipeline

__all__ = ["pad_to_multiple", "SFFPipeline", "SPPipeline"]
