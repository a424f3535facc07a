"""Data, sequence and tensor parallelism over ``torch.distributed``."""
from .distributed import (  # noqa: F401
    all_reduce_mean,
    all_reduce_sum,
    broadcast_one_to_all,
    copy_to,
    free_port,
    gather_along,
    init_distributed,
    launch,
    local_batch_slice,
    plan_ranks,
    process_allgather,
    rank,
    reduce_from,
    shutdown,
    world_size,
)
from .mesh import (  # noqa: F401
    Axis,
    Grid,
    make_grid,
    pad_batch_to_dp,
    shard_batch,
    shard_model,
    sp_size,
)
