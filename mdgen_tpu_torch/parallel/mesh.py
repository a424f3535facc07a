"""The (dp, sp, tp) rank grid and its sharding rules (the port's counterpart
of ``mdgen_tpu/parallel/mesh.py``).

JAX shards one jitted step over a device mesh with GSPMD; the port runs one
process a rank and says where every shard lives and which collective joins
them:

  * ``dp``: data parallelism. Each dp index loads its rows of the global
    batch; gradients are averaged over dp.
  * ``sp``: sequence parallelism over the frame axis T. Each sp index holds
    frames ``[i * T/sp, (i + 1) * T/sp)`` of every trunk activation. The
    residue attention, the IPA and the MLPs are local; the frame attention
    all-gathers its keys and values (``models/attention.py``); the Hyena
    operator gathers its whole input (``models/latent_model.py``); means
    over T all-reduce their sums. This divides activation memory by sp, the
    lever for ATLAS-scale (T=250 x L=256) batches that do not fit one card.
  * ``tp``: Megatron tensor parallelism. The port chooses what to shard
    (GSPMD's layout is not semantics); ``tp_specs`` names it:
      - every ``RoPEAttention``'s ``qkv_proj`` column-parallel by head: a
        rank takes its heads' q, k and v rows of the fused ``[3C, C]``
        weight, and its heads' slices of ``bias_k`` / ``bias_v``; its
        ``out_proj`` row-parallel, the bias added once after the all-reduce;
      - ``fc1`` column-parallel and ``fc2`` row-parallel in the trunk
        layers, in each ``IPALayer`` and in the design head;
      - a dimension that tp does not divide stays replicated, as JAX's
        ``param_sharding`` leaves it;
      - everything else is replicated: IPA's ``linear_*``, the embeddings,
        adaLN, the output heads and Hyena (whose ``in_proj`` JAX leaves
        unsharded too).
The ranks of one dp index and one sp line share a tp group, and so on:
rank ``(d * sp + s) * tp + t`` holds grid point (d, s, t), dp outermost and
tp innermost as ``make_mesh`` reshapes the devices. ``data`` is the dp x sp
plane of one tp index: the ranks whose gradients of one shard are averaged.
The model axes stay inside one host (``distributed.plan_ranks``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..models.attention import RoPEAttention
from ..ops import sum_of_squares
from .distributed import _gather, _sum, all_reduce_mean, barrier, process_allgather
from .distributed import rank as _rank, world_size


@dataclass(frozen=True, eq=False)
class Axis:
    """One mesh axis as this rank sees it: its size, this rank's index on
    it and the process group of its line (None: the whole world, or no
    group at size 1)."""
    size: int = 1
    index: int = 0
    group: object = field(default=None, repr=False)

    def __deepcopy__(self, memo):  # a process group is shared, not copied
        return self

    def mean(self, tensors: list) -> list:
        """Each tensor's mean over the axis (``all_reduce_mean``)."""
        return list(tensors) if self.size == 1 else all_reduce_mean(tensors, self.group)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The axis' rows of ``t`` concatenated in order (``process_allgather``)."""
        return t if self.size == 1 else process_allgather(t, self.group)

    def in_turn(self, fn):
        """``fn()`` on index 0 first, then on the others, so they read what
        index 0 writes (a cache). A failure on index 0 still lets the others
        go on: they meet it in ``fn`` themselves."""
        if self.index == 0:
            try:
                return fn()
            finally:
                if self.size > 1:
                    barrier(self.group)
        barrier(self.group)
        return fn()


@dataclass(frozen=True)
class Grid:
    dp: Axis = Axis()
    sp: Axis = Axis()
    tp: Axis = Axis()
    data: Axis = Axis()  # dp x sp, one tp index

    def frames(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's sp slice of ``x`` along its frame axis ``dim``."""
        sp = self.sp
        if sp.size == 1:
            return x
        T = x.shape[dim]
        if T % sp.size:
            raise ValueError(f"the frame axis T={T} is not a multiple of sp={sp.size}")
        n = T // sp.size
        return x.narrow(dim, sp.index * n, n)


def make_grid(dp: int, sp: int = 1, tp: int = 1) -> Grid:
    """The grid of the process group (every rank calls it, in the same
    order: each line's group is made on every rank). Raises unless dp * sp
    * tp ranks fill it."""
    world, me = world_size(), _rank()
    if dp * sp * tp != world:
        raise ValueError(f"mesh {dp}x{sp}x{tp} != {world} ranks")
    coords = [(r // (sp * tp), (r // tp) % sp, r % tp) for r in range(world)]
    d, s, t = coords[me]

    def axis(size, index, key):
        """The axis of the ranks that share ``key(coords)`` with this one."""
        if size == 1:
            return Axis()
        if size == world:
            return Axis(size, index)
        mine = None
        for line in sorted({key(c) for c in coords}):
            ranks = [r for r, c in enumerate(coords) if key(c) == line]
            group = torch.distributed.new_group(ranks)
            if me in ranks:
                mine = group
        return Axis(size, index, mine)

    return Grid(dp=axis(dp, d, lambda c: (c[1], c[2])),
                sp=axis(sp, s, lambda c: (c[0], c[2])),
                tp=axis(tp, t, lambda c: (c[0], c[1])),
                data=axis(dp * sp, d * sp + s, lambda c: c[2]))


def sp_size(grid: Optional[Grid]) -> int:
    return 1 if grid is None else grid.sp.size


# batch keys whose axis 1 is the frame axis T (sp-shardable).
# NOT torsion_mask: it is [B, L, 7] — axis 1 is the residue axis.
_T_AXIS_KEYS = frozenset(
    {"atom14", "atom37", "torsions", "trans", "rots"}
)


def pad_batch_to_dp(batch: dict, grid: Optional[Grid]):
    """Pad every leading (batch) axis to a dp multiple by repeating row 0.

    Serving CLIs choose batch sizes by peptide grouping, not mesh shape;
    padding (dropped by the caller at save time) keeps every rank holding an
    equal shard. Returns ``(padded_batch, original_B)``.
    """
    sizes = [v.shape[0] for v in batch.values() if hasattr(v, "ndim") and v.ndim]
    if not sizes:
        return batch, 0
    B = sizes[0]
    if any(s != B for s in sizes):
        raise ValueError(f"unequal leading batch dims: {sorted(set(sizes))}")
    if grid is None:
        return batch, B
    pad = -B % grid.dp.size
    if pad == 0:
        return batch, B

    def put(x):
        # the unequal-dims check above guarantees every ndim>=1 array leads
        # with B; only non-array metadata and 0-dim values pass through
        if not hasattr(x, "ndim") or x.ndim < 1:
            return x
        return np.concatenate([x, np.repeat(x[:1], pad, axis=0)])

    return {k: put(v) for k, v in batch.items()}, B


def shard_batch(grid: Optional[Grid], batch: dict) -> dict:
    """This rank's part of a host batch: rows ``[d * B/dp, (d + 1) * B/dp)``
    of every array whose leading axis dp divides, and under sp the frame
    slice (axis 1) of the trajectory keys in ``_T_AXIS_KEYS`` whose T sp
    divides. Other arrays (scalars, a leading axis dp does not divide) and
    non-array metadata stay whole, as JAX replicates them."""
    if grid is None:
        return batch
    dp, sp = grid.dp, grid.sp

    def put(key, x):
        if not hasattr(x, "ndim") or x.ndim < 1 or x.shape[0] % dp.size:
            return x
        n = x.shape[0] // dp.size
        x = x[dp.index * n:(dp.index + 1) * n]
        if sp.size > 1 and key in _T_AXIS_KEYS and x.ndim >= 2 and x.shape[1] % sp.size == 0:
            m = x.shape[1] // sp.size
            x = x[:, sp.index * m:(sp.index + 1) * m]
        return x

    return {k: put(k, v) for k, v in batch.items()}


# -- tensor-parallel sharding -------------------------------------------------

# how a sharded tensor splits: (dim, blocks) — ``blocks`` equal blocks along
# ``dim`` (q, k and v of the fused projection), each split over tp
_QKV, _ROWS, _COLS, _HEAD = (0, 3), (0, 1), (1, 1), (2, 1)


def tp_specs(model: torch.nn.Module, tp: int) -> dict:
    """{parameter name: (dim, blocks)} of the tensors a tp of ``tp`` shards
    (module docstring); every other parameter is replicated."""
    specs = {}
    if tp == 1:
        return specs
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, RoPEAttention) and mod.num_heads % tp == 0:
            specs.update({pre + "qkv_proj.weight": _QKV, pre + "qkv_proj.bias": _QKV,
                          pre + "bias_k": _HEAD, pre + "bias_v": _HEAD,
                          pre + "out_proj.weight": _COLS})
        fc1, fc2 = getattr(mod, "fc1", None), getattr(mod, "fc2", None)
        if isinstance(fc1, torch.nn.Linear) and isinstance(fc2, torch.nn.Linear) and \
                fc1.out_features % tp == 0:
            specs.update({pre + "fc1.weight": _ROWS, pre + "fc1.bias": _ROWS,
                          pre + "fc2.weight": _COLS})
    return specs


def shard_tensor(full: torch.Tensor, spec, tp: Axis) -> torch.Tensor:
    """This tp rank's shard of a full tensor."""
    dim, blocks = spec
    parts = full.chunk(blocks, dim)
    n = parts[0].shape[dim] // tp.size
    return torch.cat([p.narrow(dim, tp.index * n, n) for p in parts], dim).contiguous()


def join_shards(shards: list, spec) -> torch.Tensor:
    """The full tensor from every tp rank's shard, in tp order."""
    dim, blocks = spec
    parts = [s.chunk(blocks, dim) for s in shards]
    return torch.cat([torch.cat([p[b] for p in parts], dim) for b in range(blocks)], dim)


def shard_model(model: torch.nn.Module, grid: Grid) -> dict:
    """Shard a model built at full size in place: each tensor of
    ``tp_specs`` keeps this rank's shard, the modules that shard read
    ``tp``, and the model reads ``sp`` (and hands it to its trunk layers).
    Returns the specs."""
    specs = tp_specs(model, grid.tp.size)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in specs:
                p.data = shard_tensor(p.data, specs[name], grid.tp)
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if pre + "qkv_proj.weight" in specs or pre + "fc1.weight" in specs:
            mod.tp = grid.tp
    if grid.sp.size > 1:
        model.sp = grid.sp
    return specs


def full_tensors(named: dict, specs: dict, tp: Axis) -> dict:
    """{name: full tensor} from this rank's {name: tensor}: the sharded ones
    gathered over tp, one all-gather per dtype (every rank of the tp group
    calls it)."""
    out = dict(named)
    by_dtype: dict = {}
    for k in named:
        if k in specs:
            by_dtype.setdefault(named[k].dtype, []).append(k)
    for keys in by_dtype.values():
        ranks = _gather(torch.cat([named[k].reshape(-1) for k in keys]), tp.group)
        offset = 0
        for k in keys:
            n = named[k].numel()
            out[k] = join_shards([r[offset:offset + n].view_as(named[k]) for r in ranks],
                                 specs[k])
            offset += n
    return out


def shard_tensors(named: dict, specs: dict, tp: Axis) -> dict:
    """{name: this rank's shard} of {name: full tensor}."""
    return {k: shard_tensor(v, specs[k], tp) if k in specs else v for k, v in named.items()}


def global_sq_norm(tensors: list, sharded: list, tp: Axis) -> torch.Tensor:
    """The squared global norm of tensors of which ``sharded[i]`` says
    whether tensor i is a tp shard: each shard counted once (an all-reduce
    over tp), each replicated tensor once; each part's sum of squares in one
    launch on the card (``ops.sum_of_squares``)."""
    zero = tensors[0].new_zeros((), dtype=torch.float32)
    rep, part = ([t for t, s in zip(tensors, sharded) if s == which] for which in (False, True))
    rep = sum_of_squares(rep) if rep else zero
    part = sum_of_squares(part) if part else zero
    return rep + _sum(part, tp.group) if tp.size > 1 else rep + part
