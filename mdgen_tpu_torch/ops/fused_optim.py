"""The train step's optimizer pass: the gradients' global norm
(:func:`sum_of_squares`) and one fused clip, Adam (or AdamW) and EMA update
over every parameter tensor (:func:`fused_adam`), with optax 0.2.6's
semantics (``runtime/optim.py``).

CPU tensors take the plain versions, which are the eager loop the train step
ran before the kernel; CUDA tensors take ``csrc/fused_adam.cu`` (one launch
each for up to ``max_tensors()`` tensors; or raise). Neither reads the
device from the host: the norm stays a device tensor that the update reads,
and the bias corrections are f32 scalars computed on the host. The kernel's
p, mu, nu and EMA are bit-equal to the plain version's on the card given
the same norm; its sum of squares is taken in another, fixed order (f64
across blocks), so the norm agrees to rounding and repeats bit for bit.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ._common import launch, on_cpu

CHUNK = 8192  # elements a block


def sum_of_squares_plain(tensors, root: bool = False) -> torch.Tensor:
    """sum(t**2) over every element of every tensor, in f32; with ``root``
    its square root (optax.global_norm)."""
    s = sum((t.float() ** 2).sum() for t in tensors)
    return torch.sqrt(s) if root else s


def bias_corrections(b1: float, b2: float, count: int):
    """1 - b1**count and 1 - b2**count as f32 CPU tensors, as optax computes
    them."""
    return 1 - torch.tensor(b1) ** count, 1 - torch.tensor(b2) ** count


def ema_update_plain(ema, params, decay: float) -> None:
    """ema = ema * decay + (1 - decay) * p, in place."""
    for e, p in zip(ema, params):
        e.copy_(e * decay + (1 - decay) * p)


@torch.no_grad()
def fused_adam_plain(params, grads, mu, nu, ema, norm, *, count: int, lr: float,
                     grad_clip: float, b1: float, b2: float, eps: float, weight_decay: float,
                     ema_decay: float) -> None:
    """One optimizer step in place, tensor by tensor: clip the gradients by
    ``norm`` (their global norm, a 0-dim tensor) as ``(g / norm) *
    grad_clip`` where ``norm >= grad_clip``; Adam's moments ``mu`` and ``nu``
    and its update, with ``weight_decay * p`` added (AdamW) when non-zero, at
    step ``count`` (1 on the first); then, with an ``ema`` list, the EMA of
    the updated parameters."""
    keep = norm < grad_clip
    dev = params[0].device
    bc1, bc2 = (bc.to(dev) for bc in bias_corrections(b1, b2, count))
    for p, g, m, v in zip(params, grads, mu, nu):
        g = torch.where(keep, g, (g / norm) * grad_clip)
        m.copy_((1 - b1) * g + b1 * m)
        v.copy_((1 - b2) * g**2 + b2 * v)
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            u = u + weight_decay * p
        p.add_(-lr * u)
    if ema is not None:
        ema_update_plain(ema, params, ema_decay)


# -- CUDA ----------------------------------------------------------------------

# device -> the sum's block counter: zero between calls, which therefore run
# in the order of one stream on a device
_COUNTERS: dict = {}


@functools.lru_cache(maxsize=1)
def max_tensors() -> int:
    """The most tensors one launch takes (256 with CUDA 12.1's 32 KB of
    kernel parameters)."""
    from . import _build

    return _build.build().mdgen_opt_max_tensors()


def _checked(device, rows) -> None:
    for row in rows:
        for t in row:
            if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"the optimizer kernels take contiguous float32 tensors on "
                                 f"{device}, got {t.dtype} on {t.device} (contiguous: "
                                 f"{t.is_contiguous()})")


def _launch_groups(rows):
    """(pointers [len(rows) * n] int64, sizes [n] int64, n) for each launch:
    the tensors that hold elements, at most ``max_tensors()`` a launch."""
    keep = [i for i, t in enumerate(rows[0]) if t.numel()]
    step = max_tensors()
    for lo in range(0, len(keep), step):
        idx = keep[lo:lo + step]
        ptrs = np.array([row[i].data_ptr() for row in rows for i in idx], dtype=np.int64)
        yield ptrs, np.array([rows[0][i].numel() for i in idx], dtype=np.int64), len(idx)


def sum_of_squares(tensors, root: bool = False) -> torch.Tensor:
    """See :func:`sum_of_squares_plain`. On the card: a 0-dim f32 tensor that
    the host never reads, one launch for up to ``max_tensors()`` tensors."""
    tensors = list(tensors)
    if not tensors:
        raise ValueError("sum_of_squares needs at least one tensor")
    if on_cpu(tensors[0]):
        return sum_of_squares_plain(tensors, root)
    dev = tensors[0].device
    _checked(dev, [tensors])
    groups = list(_launch_groups([tensors]))
    if not groups:  # no elements
        return torch.zeros((), dtype=torch.float32, device=dev)
    blocks = [int(((sizes + CHUNK - 1) // CHUNK).sum()) for _, sizes, _ in groups]
    partials = torch.empty(sum(blocks), dtype=torch.float64, device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)  # the sum and its root
    if dev not in _COUNTERS:
        _COUNTERS[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    offset = 0
    for k, ((ptrs, sizes, n), b) in enumerate(zip(groups, blocks)):
        counter = _COUNTERS[dev].data_ptr() if k == len(groups) - 1 else None
        launch("mdgen_sum_squares", dev, ptrs.ctypes.data, sizes.ctypes.data, n, CHUNK,
               partials.data_ptr(), offset, len(partials), counter, out.data_ptr())
        sum_of_squares.launches += 1
        offset += b
    return out[1] if root else out[0]


def fused_adam(params, grads, mu, nu, ema, norm, *, count: int, lr: float, grad_clip: float,
               b1: float, b2: float, eps: float, weight_decay: float,
               ema_decay: float) -> None:
    """See :func:`fused_adam_plain`. On the card: one launch for up to
    ``max_tensors()`` tensors; ``norm`` a 0-dim f32 tensor on their device,
    read there."""
    if on_cpu(params[0]):
        fused_adam_plain(params, grads, mu, nu, ema, norm, count=count, lr=lr,
                         grad_clip=grad_clip, b1=b1, b2=b2, eps=eps,
                         weight_decay=weight_decay, ema_decay=ema_decay)
        return
    rows = [params, grads, mu, nu] + ([ema] if ema is not None else [])
    if len({len(r) for r in rows}) != 1 or any(
            a.shape != p.shape for r in rows[1:] for a, p in zip(r, params)):
        raise ValueError("fused_adam: params, grads, mu, nu (and ema) must match tensor "
                         "for tensor")
    dev = params[0].device
    _checked(dev, rows + [[norm]])
    if norm.numel() != 1:
        raise ValueError("fused_adam: norm must be one value")
    bc1, bc2 = bias_corrections(b1, b2, count)
    scalars = np.array([grad_clip, 1 - b1, b1, 1 - b2, b2, float(bc1), float(bc2), eps,
                        weight_decay, -lr, ema_decay, 1 - ema_decay], dtype=np.float32)
    if ema is None:
        rows = rows + [params]  # an unread row
    for ptrs, sizes, n in _launch_groups(rows):
        launch("mdgen_fused_adam", dev, ptrs.ctypes.data, sizes.ctypes.data, n, CHUNK,
               norm.data_ptr(), scalars.ctypes.data, int(ema is not None))
        fused_adam.launches += 1


sum_of_squares.launches = 0
fused_adam.launches = 0
