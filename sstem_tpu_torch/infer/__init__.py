from sstem_tpu_torch.infer.tiles import (
    infer_full,
    infer_tiled,
    pad_to_multiple,
    tile_image,
    untile,
)
from sstem_tpu_torch.infer.pipeline import SFFPipeline, SPPipeline

__all__ = [
    "infer_full",
    "infer_tiled",
    "pad_to_multiple",
    "tile_image",
    "untile",
    "SFFPipeline",
    "SPPipeline",
]
