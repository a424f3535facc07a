"""The reference Hyena trunk: ``model.Model`` with every trunk layer's frame
sublayer the order-2 Hyena operator (MDGen's ``--hyena``,
``latent_model.py`` with ``standalone_hyena.py``'s ``HyenaOperator``) in
place of frame attention. Plain PyTorch in float32 over the dict of named
tensors, as ``model.py``.

The operator over u [N, T, C] (N = B L sequences of T frames):

    z = in_proj(u)                          [N, T, 3C]
    z = depthwise width-3 convolution over T, padded by 2 on both sides,
        the first T outputs kept (each output sees its frame and the two
        before it)
    x0, x1, v = the three C-wide chunks of z
    k = the implicit filter [T, C] (below)
    y = (v x1) * k + bias (v x1)            the long convolution, cropped
    out = out_proj(y x0)

The implicit filter: positional features of ``l_max = num_frames``
positions, [t | Re e^{-i f w} | Im e^{-i f w}] with t = linspace(0, 1),
w = 2 pi n / l_max and the one band f = 1e-4 (three features), the first T
of them through three layers ``sin(freq_i * (W_i h + b_i))`` of width 64
and a last linear layer to C without bias, times the decay
``exp(-t |delta_c|)``, delta_c from ln(0.01) / 1.5 to ln(0.01) / 0.3 over
the channels.

The long convolution is computed from its definition: the full linear
convolution of v x1 with k, (v x1 * k)[i] = sum_j (v x1)[j] k[i - j] for i
in [0, 2T - 1), by ``torch.fft`` at its own size, 2T - 1 rounded up to a
multiple of 1024 (the program transforms at 2T), with the inverse's own
1/n; then the T outputs [T - 1, 2T - 1) are kept. The tests hold it to a
direct sum.

Departures from the published operator (HazyResearch's standalone Hyena as
MDGen carries it), each as the program and the JAX package have it:
- the crop ``[T - 1 : 2T - 1]`` of the full convolution, which PARITY.md's
  row for ``standalone_hyena.py`` gives as MDGen's; HazyResearch's file
  keeps the first T, the causal part;
- three sine frequency vectors ``sin_freq_0..2``, one a layer, where the
  published filter shares one ``Sin`` module (one vector) among its three
  layers; they start equal, and only training tells them apart;
- no dropout (the published default is 0) and no mask: the operator mixes
  every frame, so the reference refuses a frame mask that is not all ones.
Every product is float32 at ``prec``'s matmul setting; ``prec.q`` rounds
nothing here, since the configuration computes in float32.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import model as rmodel
from . import train as rtrain

FILTER_LAYERS = 3  # sine layers of the implicit filter


def positional_features(l_max: int) -> tuple:
    """([l_max, 3] = [t | Re e^{-i f w} | Im e^{-i f w}], t [l_max, 1]),
    float32, from float64."""
    t = np.linspace(0, 1, l_max)[:, None]
    w = 2 * math.pi * np.arange(l_max, dtype=np.float64)[:, None] / l_max
    z = np.exp(-1j * 1e-4 * w)
    feats = np.concatenate([t, z.real, z.imag], axis=-1)
    return torch.from_numpy(feats.astype(np.float32)), torch.from_numpy(t.astype(np.float32))


def decay_rates(C: int) -> torch.Tensor:
    """[C] deltas, ln(0.01) / 1.5 to ln(0.01) / 0.3."""
    return torch.from_numpy(np.linspace(math.log(1e-2) / 1.5, math.log(1e-2) / 0.3, C)
                            .astype(np.float32))


def linear_convolution(u: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """u [N, C, T], k [C, T] -> the full linear convolution over T, [N, C,
    2T - 1], by FFTs of 2T - 1 rounded up to a multiple of 1024."""
    T = u.shape[-1]
    n = -(-(2 * T - 1) // 1024) * 1024
    y = torch.fft.irfft(torch.fft.rfft(u, n=n) * torch.fft.rfft(k, n=n), n=n)
    return y[..., :2 * T - 1]


class Model(rmodel.Model):
    """``model.Model`` whose trunk layers mix frames by the Hyena operator."""

    def attention(self, x, mask, axis, name):
        if axis != 1:
            return super().attention(x, mask, axis, name)
        if not bool((mask > 0).all()):
            raise ValueError("the Hyena operator takes no frame mask: every frame must be valid")
        B, T, L, C = x.shape
        out = self.hyena(x.transpose(1, 2).reshape(B * L, T, C), name)
        return out.reshape(B, L, T, C).transpose(1, 2)

    def implicit_filter(self, T: int, name: str) -> torch.Tensor:
        """[C, T]: the filter's first T positions."""
        feats, t = positional_features(self.cfg["num_frames"])
        dev = self.w(name + ".mlp_out.weight").device
        h, t = feats[:T].to(dev), t[:T].to(dev)
        for i in range(FILTER_LAYERS):
            h = torch.sin(self.w(f"{name}.sin_freq_{i}") * self.dense(h, f"{name}.mlp_{i}"))
        h = F.linear(h, self.w(name + ".mlp_out.weight"))
        return (h * torch.exp(-t * decay_rates(self.C).to(dev).abs())).transpose(0, 1)

    def hyena(self, u: torch.Tensor, name: str) -> torch.Tensor:
        """The order-2 operator over u [N, T, C] (module docstring)."""
        N, T, C = u.shape
        z = self.dense(u, name + ".in_proj").transpose(1, 2)  # [N, 3C, T]
        w, b = self.w(name + ".short_filter.weight")[:, 0], self.w(name + ".short_filter.bias")
        zp = F.pad(z, (2, 0))  # the right padding only makes outputs past T, which are cropped
        z = b[:, None] + w[:, 0, None] * zp[..., :T] + w[:, 1, None] * zp[..., 1:T + 1] \
            + w[:, 2, None] * zp[..., 2:T + 2]
        x0, x1, v = z.chunk(3, dim=1)
        vx = v * x1
        k = self.implicit_filter(T, name + ".filter_fn")
        y = linear_convolution(vx, k)[..., T - 1:2 * T - 1] \
            + vx * self.w(name + ".filter_fn.bias")[:, None]
        return self.dense((y * x0).transpose(1, 2), name + ".out_proj")


@contextlib.contextmanager
def hyena_trunk():
    """``train.train_steps`` builds ``Model`` by its module-level name: this
    file's for the duration, the loop itself reused unchanged."""
    old = rtrain.Model
    rtrain.Model = Model
    try:
        yield
    finally:
        rtrain.Model = old
