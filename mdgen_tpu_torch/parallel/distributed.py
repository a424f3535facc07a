"""Ranks and collectives over ``torch.distributed`` (the port's counterpart of
``mdgen_tpu/parallel/distributed.py``).

JAX runs one jitted program over a (dp, sp, tp) device mesh, so a mesh run
computes what one device computes. The port keeps that property with one
process per rank and explicit collectives:

  * ``plan_ranks`` lays out ``dp * sp * tp`` ranks over hosts, the model
    axes (sp, tp) inside one host as ``make_global_mesh`` asserts;
    ``launch`` starts this host's ranks and ``init_distributed`` joins them
    at ``tcp://ADDRESS`` (NCCL for CUDA ranks, one card each; gloo for CPU
    ranks or ranks sharing one card). One rank joins no group and runs no
    collective at all;
  * ``all_reduce_mean`` averages tensors over a group (one flattened
    all-reduce per dtype): the gradients, metrics and validation means;
  * ``broadcast_one_to_all`` makes rank 0's stop poll everyone's decision;
  * ``process_allgather`` concatenates row-sharded tensors over a group;
  * the autograd collectives of the model axes, each over one mesh axis
    (``mesh.Axis``): ``copy_to`` (identity; its backward all-reduces) and
    ``reduce_from`` (all-reduce; its backward is the identity), Megatron's
    f and g around the tensor-parallel projections; ``all_reduce_sum``
    (all-reduce both ways), the sums over the frame axis under sequence
    parallelism; ``gather_along`` (all-gather; its backward a
    reduce-scatter), the frame attention's keys and values.
Under gloo a CUDA tensor is staged through host memory, and half precision
is summed in f32.
"""
from __future__ import annotations

import datetime
import os
import socket
import tempfile
from dataclasses import dataclass
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


def world_size(group=None) -> int:
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


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


# -- the rank layout ----------------------------------------------------------


@dataclass
class RankPlan:
    """Where this host's ranks run: ``world`` ranks in all (``dp * sp *
    tp``), ``local`` of them here, ranks ``base + i`` on ``devices[i]``,
    meeting at ``address``."""
    world: int
    local: int
    base: int
    devices: list
    backend: str
    address: str | None
    dp: int = 1
    sp: int = 1
    tp: int = 1


def plan_ranks(dp_size: int, device="cuda", sp_size: int = 1, tp_size: int = 1,
               num_processes: Optional[int] = None, process_id: Optional[int] = None,
               address: Optional[str] = None, backend: Optional[str] = None) -> RankPlan:
    """The rank layout of a (dp, sp, tp) grid over ``num_processes`` hosts.

    ``dp_size`` -1 takes the remaining ranks: every visible card of each
    host (``device`` "cuda" with no index), else one rank a host. Each host
    runs ``world / hosts`` ranks, started by one command. CUDA ranks take
    ``cuda:i``, one card each; a device with an index (``cuda:0``) holds
    every rank of the host, which needs the gloo backend. The model axes
    stay inside one host: sp * tp must divide the ranks of a host. Raises
    where the ranks do not fill the grid."""
    device = torch.device(device)
    hosts = num_processes or 1
    model = sp_size * tp_size
    if dp_size == -1:
        per_host = torch.cuda.device_count() if device.type == "cuda" and device.index is None \
            else 1
        total = max(per_host, 1) * hosts
        if total % model:
            raise ValueError(f"{total} ranks are not a multiple of sp*tp={model}: give "
                             "--dp_size")
        dp_size = total // model
    world = dp_size * model
    if world % hosts:
        raise ValueError(f"{world} ranks (dp*sp*tp) are not a multiple of --num_processes "
                         f"{hosts}")
    local = world // hosts
    if local % model:
        raise ValueError(f"sp*tp={model} must divide the {local} ranks of one host (the "
                         "model axes stay inside one host)")
    pid = process_id or 0
    if not 0 <= pid < hosts:
        raise ValueError(f"--process_id {pid} outside [0, {hosts})")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda" and device.index is None:
        devices = [torch.device("cuda", i) for i in range(local)]
    else:
        if device.type == "cuda" and local > 1 and backend == "nccl":
            raise ValueError(f"{local} NCCL ranks on {device}: NCCL takes one card a rank; "
                             "--dist_backend gloo lets ranks share one")
        devices = [device] * local
    if world > 1 and address is None:
        if hosts > 1:
            raise ValueError("--num_processes > 1 needs --coordinator_address HOST:PORT")
        address = f"localhost:{free_port()}"
    return RankPlan(world, local, pid * local, devices, backend, address, dp_size, sp_size,
                    tp_size)


def launch(plan: RankPlan, fn, *args):
    """Run ``fn(rank, device, *args)`` on each of this host's ranks, each in
    the process group of the plan; returns what the host's first rank
    returned. One local rank runs here; more are spawned, one process each,
    and the first one's result comes back through a file."""
    if plan.local == 1:
        return _rank_main(0, plan, fn, args)
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="mdgen_ranks_") as tmp:
        out = os.path.join(tmp, "rank0.pt")
        mp.start_processes(_spawned, args=(plan, fn, args, out), nprocs=plan.local,
                           start_method="spawn")
        return torch.load(out, weights_only=False)  # written by _spawned below


def _spawned(i, plan, fn, args, out):
    if plan.devices[i].type == "cpu":  # the host's cores, shared by its ranks
        torch.set_num_threads(max(1, torch.get_num_threads() // plan.local))
    result = _rank_main(i, plan, fn, args)
    if i == 0:
        torch.save(result, out)


def _rank_main(i, plan, fn, args):
    rank_, device = plan.base + i, plan.devices[i]
    init_distributed(plan.address, plan.world, rank_, plan.backend, device)
    try:
        return fn(rank_, device, *args)
    finally:
        shutdown()


# -- collectives over a group -------------------------------------------------


def _staged(group=None) -> bool:
    return dist.get_backend(group) == "gloo"


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """A private copy of ``t`` for the backend: on the host and, for half
    precision, in f32 under gloo."""
    if _staged(group):
        dt = torch.float32 if t.dtype in (torch.bfloat16, torch.float16) else t.dtype
        return t.detach().to("cpu", dt, copy=True).contiguous()
    return t.detach().clone(memory_format=torch.contiguous_format)


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    """The all-reduced sum of ``t`` over ``group``, a new tensor like ``t``."""
    w = _wire(t, group)
    dist.all_reduce(w, group=group)
    return w.to(t.device, t.dtype)


def _gather(t: torch.Tensor, group) -> list:
    """Every rank's ``t`` over ``group``, in group-rank order."""
    w = _wire(t, group)
    parts = [torch.empty_like(w) for _ in range(world_size(group))]
    dist.all_gather(parts, w, group=group)
    return [p.to(t.device, t.dtype) for p in parts]


def all_reduce_mean(tensors: list, group=None) -> list:
    """The mean over the ranks of ``group`` (default: every rank) of each
    tensor, one flattened all-reduce per dtype (the tensors themselves are
    left as they are). Identity in one process."""
    n = world_size(group)
    if n == 1:
        return list(tensors)
    out = list(tensors)
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    for idx in groups.values():
        flat = _sum(torch.cat([tensors[i].detach().reshape(-1) for i in idx]), group) / n
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


def process_allgather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each: its rows of a global
    batch), concatenated along dim 0 in rank order, on every rank of
    ``group`` (default: every rank)."""
    if world_size(group) == 1:
        return t
    return torch.cat(_gather(t, group))


def barrier(group=None) -> None:
    if world_size(group) > 1:
        dist.barrier(group=group)


# -- autograd collectives over one mesh axis ----------------------------------


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.axis.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _sum(x, axis.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _sum(x, axis.group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.axis.group), None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis, ctx.n = dim, axis, x.shape[dim]
        return torch.cat(_gather(x, axis.group), dim)

    @staticmethod
    def backward(ctx, g):
        # reduce-scatter: the sum over ranks of each rank's gradient, this
        # rank's slice of it
        dim, axis, n = ctx.dim, ctx.axis, ctx.n
        if _staged(axis.group):
            return _sum(g, axis.group).narrow(dim, axis.index * n, n), None, None
        src = g.movedim(dim, 0).contiguous()
        out = src.new_empty((n, *src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=axis.group)
        return out.movedim(0, dim), None, None


def _live(axis) -> bool:
    return axis is not None and axis.size > 1


def copy_to(x: torch.Tensor, axis) -> torch.Tensor:
    """Megatron's f: ``x`` as it is; its gradient is all-reduced over
    ``axis``. Put before a projection whose output columns are sharded."""
    return _CopyTo.apply(x, axis) if _live(axis) else x


def reduce_from(x: torch.Tensor, axis) -> torch.Tensor:
    """Megatron's g: the all-reduced sum of ``x`` over ``axis``; its gradient
    passes as it is. Put after a projection whose input rows are sharded."""
    return _ReduceFrom.apply(x, axis) if _live(axis) else x


def all_reduce_sum(x: torch.Tensor, axis) -> torch.Tensor:
    """The all-reduced sum of ``x`` over ``axis``, differentiable: the
    gradient is all-reduced too (every rank computes the whole sum and uses
    it, so each rank's gradient of it is summed)."""
    return _AllReduceSum.apply(x, axis) if _live(axis) else x


def gather_along(x: torch.Tensor, dim: int, axis) -> torch.Tensor:
    """Every rank's ``x`` over ``axis``, concatenated along ``dim`` in rank
    order; the backward reduce-scatters the gradient."""
    return _GatherAlong.apply(x, dim, axis) if _live(axis) else x
