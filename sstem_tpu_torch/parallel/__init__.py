from sstem_tpu_torch.parallel.ddp import (
    CrossRankBatchNorm2d,
    all_mean,
    convert_batchnorm,
    device_for_rank,
    init_process_group,
    rank_rows,
    teardown,
    unwrap,
    wrap,
)
from sstem_tpu_torch.parallel.launch import spawn
from sstem_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    replicate,
    shard_batch,
)
from sstem_tpu_torch.parallel.spatial import spatial_apply

__all__ = ["CrossRankBatchNorm2d", "Mesh", "all_mean", "convert_batchnorm",
           "device_for_rank", "init_process_group", "make_mesh", "rank_rows",
           "replicate", "shard_batch", "spatial_apply", "spawn", "teardown",
           "unwrap", "wrap"]
