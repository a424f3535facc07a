"""Data, sequence and tensor parallelism over ``torch.distributed``.

The package re-exports ``distributed``: process set-up and the collectives
the model calls, a leaf of the port that ``models`` imports. The (dp, sp,
tp) grid and its sharding rules sit above the model, whose tree they know,
and are imported from ``parallel.mesh``.
"""
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
