"""DiT-style primitive layers (port of ``mdgen_tpu/models/layers.py``).

Dtype rule, mirroring flax: a layer given a compute dtype casts its input and
its parameters to that dtype (``dense(x, lin, dt)``); a layer without one
computes in float32, the result type of its f32 input and its (possibly
bf16-rounded) parameters (``dense(x, lin)``).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.distributed import copy_to, reduce_from


def dense(x: torch.Tensor, lin: nn.Linear, dtype: Optional[torch.dtype] = None):
    """flax ``nn.Dense`` semantics on a torch ``nn.Linear``."""
    dt = dtype or torch.float32
    return F.linear(x.to(dt), lin.weight.to(dt), lin.bias.to(dt))


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """No-affine LayerNorm in f32 (flax's ``use_bias=False, use_scale=False``)."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=eps)


def modulate(x, shift, scale):
    """adaLN modulation; shift/scale get a broadcast axis inserted at 1."""
    return x * (1 + scale[:, None]) + shift[:, None]


def gelu(x):
    """Exact (erf) gelu."""
    return F.gelu(x, approximate="none")


def timestep_embedding(t, dim, max_period=10000.0):
    """[B] -> [B, dim] sinusoidal embedding, layout [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class Dropout:
    """Train-time dropout on attention probabilities, the JAX placement:
    ``p * keep_mask / keep`` with keep = 1 - rate, the mask Bernoulli(keep).
    The masks come, in call order, from a generator seeded with ``seed`` on
    ``device``. A trunk layer builds its own from its seed inside its
    (possibly checkpointed) forward, so the recompute draws the same masks:
    ``torch.utils.checkpoint`` restores only the global generators.

    Each mask is drawn at the one-process shape and sliced, so the ranks of
    a grid together draw the one-process masks: ``rows = (lo, n)`` says the
    caller holds rows lo.. of an n-row batch (its data-parallel rows), and
    a call's ``shards``, ((dim, lo, n), ...), that the tensor holds [lo, lo
    + its size) of n along ``dim`` (the heads of a tensor-parallel rank, the
    frames of a sequence-parallel one)."""

    def __init__(self, rate: float, seed: int, device, rows=None):
        self.keep = 1.0 - rate
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.rows = rows

    def mask(self, shape, device, shards=()) -> torch.Tensor:
        shards = ([] if self.rows is None else [(0, *self.rows)]) + list(shards)
        full = list(shape)
        for dim, _, n in shards:
            full[dim] = n
        m = torch.empty(full, dtype=torch.bool, device=device).bernoulli_(
            self.keep, generator=self.generator)
        for dim, lo, _ in shards:
            m = m.narrow(dim, lo, shape[dim])
        return m

    def __call__(self, p: torch.Tensor, shards=()) -> torch.Tensor:
        return p * self.mask(p.shape, p.device, shards).to(p.dtype) / self.keep


def mlp(h: torch.Tensor, fc1: nn.Linear, fc2: nn.Linear, dtype=None, tp=None) -> torch.Tensor:
    """``fc2(gelu(fc1(h)))`` in ``dtype``. Under tensor parallelism (``tp``,
    a mesh axis) fc1 holds this rank's output rows and fc2 its input
    columns: h's gradient is all-reduced (``copy_to``), fc2's partial sums
    are all-reduced (``reduce_from``) and its bias is added once after."""
    if tp is None:
        return dense(gelu(dense(h, fc1, dtype)), fc2, dtype)
    dt = dtype or torch.float32
    h = gelu(dense(copy_to(h, tp), fc1, dtype))
    return reduce_from(F.linear(h.to(dt), fc2.weight.to(dt)), tp) + fc2.bias.to(dt)


def xavier_(lin: nn.Linear, generator=None):
    nn.init.xavier_uniform_(lin.weight, generator=generator)
    nn.init.zeros_(lin.bias)


def zeros_(lin: nn.Linear):
    nn.init.zeros_(lin.weight)
    nn.init.zeros_(lin.bias)


class TimestepEmbedder(nn.Module):
    """Sinusoidal features -> 2-layer SiLU MLP (f32)."""

    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.dense_0 = nn.Linear(frequency_embedding_size, hidden_size)
        self.dense_1 = nn.Linear(hidden_size, hidden_size)

    def reset_parameters(self, generator=None):
        for lin in (self.dense_0, self.dense_1):
            nn.init.normal_(lin.weight, std=0.02, generator=generator)
            nn.init.zeros_(lin.bias)

    def forward(self, t):
        x = timestep_embedding(t, self.frequency_embedding_size)
        return dense(F.silu(dense(x, self.dense_0)), self.dense_1)


class FinalLayer(nn.Module):
    """adaLN-zero output head: LN (no affine) -> modulate -> zero-init Dense."""

    def __init__(self, hidden_size: int, out_channels: int):
        super().__init__()
        self.dense_0 = nn.Linear(hidden_size, 2 * hidden_size)
        self.dense_1 = nn.Linear(hidden_size, out_channels)

    def reset_parameters(self, generator=None):
        zeros_(self.dense_0)
        zeros_(self.dense_1)

    def forward(self, x, c):
        shift, scale = dense(F.silu(c), self.dense_0).chunk(2, dim=-1)
        return dense(modulate(layer_norm(x), shift, scale), self.dense_1)


def sincos_pos_embed(embed_dim: int, n_pos: int) -> np.ndarray:
    """Frozen 1D sin-cos table [n_pos, embed_dim], layout [sin | cos]."""
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", np.arange(n_pos, dtype=np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1).astype(np.float32)
