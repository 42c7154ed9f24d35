from diagan_tpu_torch.parallel.dist import (
    DataParallel,
    all_reduce_grads_,
    all_reduce_mean_,
    broadcast_module,
    init_data_parallel,
    per_rank_shard,
    rank_block,
    shard_logit_gather,
    sync_buffers,
)

__all__ = [
    "DataParallel",
    "all_reduce_grads_",
    "all_reduce_mean_",
    "broadcast_module",
    "init_data_parallel",
    "per_rank_shard",
    "rank_block",
    "shard_logit_gather",
    "sync_buffers",
]
