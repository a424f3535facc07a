"""Data-parallel training over ``torch.distributed``."""
from .distributed import (  # noqa: F401
    all_reduce_mean,
    broadcast_one_to_all,
    free_port,
    init_distributed,
    local_batch_slice,
    process_allgather,
    rank,
    shutdown,
    world_size,
)
