"""Hyena operator (port of ``mdgen_tpu/models/hyena.py``): an FFT long
convolution over the frame axis, the ``--hyena`` replacement of the
frame-axis attention.

Kept from the JAX module: the implicit filter (a sine MLP over the
complex-exponential positional features, times an exponential decay), the
order-2 gated recurrence with a depthwise short convolution (kernel 3,
padding 2 on both sides, cropped to the first T outputs), and the FFT long
convolution, ``fftconv`` (``ops/long_conv.py``). The FFTs are ``torch.fft``
(cuFFT on the GPU), as the JAX module leaves them to ``jnp.fft``; the filter
is computed at every forward, as in JAX.

Dtypes follow flax's promotion for layers without a compute dtype: each
projection computes in the result type of its input and its parameters
(f32 in training; bf16 under the serving cast of ``bf16-mixed``), the
filter in f32, and ``fftconv`` transforms in f32 and returns its input's
dtype. Parameter names are the flax tree's (``in_proj``, ``short_filter``,
``filter_fn.{mlp_0..2, mlp_out, sin_freq_0..2, bias}``, ``out_proj``), so
``interop.jax_params_to_state_dict`` converts them by its generic rules
(the Conv kernel [3, 1, D] transposes to conv1d's [D, 1, 3]).

Each ``HyenaOperator.forward`` is a ``tracing`` span ``model.hyena``, and
calls ``fftconv`` once at order 2 (``ops.launch_counts`` reports the calls
under ``fftconv``); the backward, which autograd runs, calls it not at all
(a checkpointed layer's recompute calls it again).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import tracing
from ..ops import fftconv
from .layers import xavier_


def positional_embedding(emb_dim: int, seq_len: int):
    """([1, L, emb_dim] = [t | Re(e^{-i f w}) | Im(e^{-i f w})], t [1, L, 1]), f32."""
    t = np.linspace(0, 1, seq_len)[None, :, None]
    bands = (emb_dim - 1) // 2
    t_rescaled = np.linspace(0, seq_len - 1, seq_len)[None, :, None]
    w = 2 * math.pi * t_rescaled / seq_len
    f = np.linspace(1e-4, bands - 1, bands)[None, None]
    z = np.exp(-1j * f * w)
    return np.concatenate([t, z.real, z.imag], axis=-1).astype(np.float32), t.astype(
        np.float32
    )


def _promoted(x, w):
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), dt


def _dense(x, lin):
    """flax ``nn.Dense`` without a compute dtype: the promoted type."""
    x, dt = _promoted(x, lin.weight)
    bias = None if lin.bias is None else lin.bias.to(dt)
    return F.linear(x, lin.weight.to(dt), bias)


def _lecun_normal_(w, fan_in, generator=None):
    """flax's default kernel init: truncated normal, variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


class HyenaFilter(nn.Module):
    """Implicit long filter: sine MLP over positional features + decay."""

    def __init__(self, d_model: int, emb_dim: int = 3, order: int = 64, seq_len: int = 1024,
                 w: float = 1.0, num_inner_mlps: int = 2, fast_decay_pct: float = 0.3,
                 slow_decay_pct: float = 1.5, target: float = 1e-2):
        super().__init__()
        self.n_mlps = num_inner_mlps + 1
        self.w = w
        z, t = positional_embedding(emb_dim, seq_len)
        self.register_buffer("z", torch.from_numpy(z), persistent=False)
        self.register_buffer("t", torch.from_numpy(t), persistent=False)
        for i in range(self.n_mlps):
            self.register_parameter(f"sin_freq_{i}", nn.Parameter(torch.full((1, order), w)))
            self.add_module(f"mlp_{i}", nn.Linear(emb_dim if i == 0 else order, order))
        self.mlp_out = nn.Linear(order, d_model, bias=False)
        max_decay = math.log(target) / fast_decay_pct
        min_decay = math.log(target) / slow_decay_pct
        deltas = np.linspace(min_decay, max_decay, d_model)[None, None].astype(np.float32)
        self.register_buffer("deltas", torch.from_numpy(deltas), persistent=False)
        self.bias = nn.Parameter(torch.zeros(d_model))

    def reset_parameters(self, generator=None):
        for i in range(self.n_mlps):
            nn.init.constant_(getattr(self, f"sin_freq_{i}"), self.w)
            lin = getattr(self, f"mlp_{i}")
            _lecun_normal_(lin.weight, lin.in_features, generator)
            nn.init.zeros_(lin.bias)
        _lecun_normal_(self.mlp_out.weight, self.mlp_out.in_features, generator)
        nn.init.normal_(self.bias, std=1.0, generator=generator)

    def filter(self, L: int) -> torch.Tensor:
        """[1, L, d_model] in f32."""
        h = self.z[:, :L]
        for i in range(self.n_mlps):
            h = torch.sin(getattr(self, f"sin_freq_{i}") * _dense(h, getattr(self, f"mlp_{i}")))
        h = _dense(h, self.mlp_out)
        return h * torch.exp(-self.t[:, :L] * self.deltas.abs())


class HyenaOperator(nn.Module):
    """Order-2 Hyena recurrence over (B, T, C) sequences."""

    def __init__(self, d_model: int, l_max: int, order: int = 2, filter_order: int = 64):
        super().__init__()
        self.d_model, self.l_max, self.order = d_model, l_max, order
        inner = d_model * (order + 1)
        self.in_proj = nn.Linear(d_model, inner)
        self.short_filter = nn.Conv1d(inner, inner, 3, padding=2, groups=inner)
        self.filter_fn = HyenaFilter(d_model * (order - 1), order=filter_order, seq_len=l_max)
        self.out_proj = nn.Linear(d_model, d_model)

    def reset_parameters(self, generator=None):
        xavier_(self.in_proj, generator)
        _lecun_normal_(self.short_filter.weight, 3, generator)
        nn.init.zeros_(self.short_filter.bias)
        self.filter_fn.reset_parameters(generator)
        xavier_(self.out_proj, generator)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        with tracing.span("model.hyena"):
            return self._forward(u)

    def _forward(self, u: torch.Tensor) -> torch.Tensor:
        B, T, C = u.shape
        l_filter = min(T, self.l_max)
        u = _dense(u, self.in_proj).transpose(1, 2)  # B, D, T
        conv = self.short_filter
        u, dt = _promoted(u, conv.weight)
        # depthwise, kernel 3, padding 2 on both sides: T + 2 outputs, keep the first T
        uc = F.conv1d(u, conv.weight.to(dt), conv.bias.to(dt), padding=2,
                      groups=conv.groups)[..., :l_filter]
        *x, v = uc.chunk(self.order + 1, dim=1)
        k = self.filter_fn.filter(l_filter)[0]  # [T, C * (order - 1)]
        k = k.transpose(0, 1).reshape(self.order - 1, C, l_filter)
        bias = self.filter_fn.bias.reshape(self.order - 1, C)
        for o, x_i in enumerate(reversed(x[1:])):
            v = fftconv(v * x_i, k[o], bias[o])
        return _dense((v * x[0]).transpose(1, 2), self.out_proj)  # B, T, C
