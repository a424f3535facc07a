"""Data parallelism over ``torch.distributed`` (the port's counterpart of
``mdgen_tpu/parallel/distributed.py``).

JAX's data-parallel step is one jitted step over the global batch, sharded
over a device mesh, so a dp run computes what one device computes. The port
keeps that property with one process per rank and explicit collectives:

  * ``init_distributed`` joins the process group at ``tcp://ADDRESS`` (NCCL
    for CUDA tensors, gloo for CPU ones, or ranks sharing one card); it does
    nothing in one process, and then no collective runs at all;
  * each rank loads rows ``local_batch_slice`` of every global batch
    (``data.Loader(num_shards, shard_id)``), after the dataset's window,
    replica and crop draws of the rows before them, and draws the step's
    random numbers for the global batch, keeping its own rows
    (``runtime.wrapper.TrainRuntime``);
  * ``all_reduce_mean`` averages the gradients (one flattened all-reduce
    per dtype), the step's metrics and the validation means over ranks;
  * ``broadcast_one_to_all`` makes rank 0's stop poll everyone's decision;
  * ``process_allgather`` concatenates row-sharded tensors on every rank.
Under gloo a CUDA tensor is staged through host memory.
"""
from __future__ import annotations

import datetime
import socket
from typing import Optional

import torch
import torch.distributed as dist


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: str = "gloo",
                     device=None, timeout_s: float = 1800.0) -> bool:
    """Join a process group of ``num_processes`` ranks as rank
    ``process_id``, rendezvous at ``tcp://coordinator_address`` (HOST:PORT;
    rank 0 listens there). No-op in one process. Returns True if a group was
    started."""
    if num_processes is None or num_processes <= 1:
        return False
    if coordinator_address is None:
        raise ValueError("more than one rank needs --coordinator_address HOST:PORT")
    init = coordinator_address if "://" in coordinator_address else \
        f"tcp://{coordinator_address}"
    if backend == "nccl" and device is not None:
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id or 0,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def free_port() -> int:
    """A TCP port of this host that is free now, for a local rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def shutdown() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def local_batch_slice(num_shards: int, shard_id: int, batch_size: int):
    """Index range [lo, hi) of the global batch this process loads: rank r's
    rows are contiguous and in rank order, as ``data.Loader`` shards them
    and ``process_allgather`` concatenates them."""
    assert batch_size % num_shards == 0, (
        f"global batch {batch_size} not divisible by {num_shards} processes"
    )
    per = batch_size // num_shards
    return shard_id * per, (shard_id + 1) * per


def _staged() -> bool:
    return dist.get_backend() == "gloo"


def _all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    if t.is_cuda and _staged():
        host = t.cpu()
        dist.all_reduce(host)
        return host.to(t.device)
    dist.all_reduce(t)
    return t


def all_reduce_mean(tensors: list) -> list:
    """The mean over ranks of each tensor, one flattened all-reduce per
    dtype (the tensors themselves are left as they are). Identity in one
    process."""
    n = world_size()
    if n == 1:
        return list(tensors)
    out = list(tensors)
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    for idx in groups.values():
        flat = _all_reduce_sum(torch.cat([tensors[i].detach().reshape(-1) for i in idx])) / n
        offset = 0
        for i in idx:
            numel = tensors[i].numel()
            out[i] = flat[offset:offset + numel].view_as(tensors[i])
            offset += numel
    return out


def broadcast_one_to_all(flag: bool) -> bool:
    """Rank 0's ``flag`` on every rank."""
    if world_size() == 1:
        return bool(flag)
    device = "cpu" if _staged() else torch.device("cuda", torch.cuda.current_device())
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=device)
    dist.broadcast(t, src=0)
    return bool(t.item())


def process_allgather(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each: its rows of a global
    batch), concatenated along dim 0 in rank order, on every rank."""
    if world_size() == 1:
        return t
    src = t.detach().contiguous()
    if src.is_cuda and _staged():
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(world_size())]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(t.device)
