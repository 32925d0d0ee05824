from sstem_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    replicate,
    shard_batch,
)
from sstem_tpu_torch.parallel.spatial import spatial_apply

__all__ = ["Mesh", "make_mesh", "replicate", "shard_batch", "spatial_apply"]
