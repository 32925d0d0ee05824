from sstem_tpu_torch.ops.pad import negative_pad_2d, replication_pad_2d
from sstem_tpu_torch.ops.resize import upsample_bilinear_align_corners
from sstem_tpu_torch.ops.warp import image_warp, spatial_transform
from sstem_tpu_torch.ops.flow import fold_flows, gen_flow, gen_flow_np, gen_line

__all__ = [
    "replication_pad_2d",
    "negative_pad_2d",
    "upsample_bilinear_align_corners",
    "image_warp",
    "spatial_transform",
    "gen_line",
    "gen_flow",
    "gen_flow_np",
    "fold_flows",
]
