"""Operations and bytes of the Hyena trunk (``--hyena``), after
``counting.py``'s rules: 2 operations a multiply-add, each input byte read
once and each output byte written once, padded positions counted.

A trunk layer's frame mixer is the order-2 Hyena operator over the B L
sequences of T frames (``reference/hyena.py``): two projections (to 3C and
back to C), a depthwise width-3 convolution over 3C channels, the implicit
filter (three sine layers of 64 and a layer to C over T positions), one
long convolution by FFTs of n = 2T points (``fftconv``: the real transforms
of the filter and of the input, their product, the inverse), and the
pointwise products around it. A real transform of n points counts 2.5 n
log2 n operations, half of a complex one's 5 n log2 n.
"""
from __future__ import annotations

import math

from . import counting

FILTER_ORDER = 64  # the implicit filter's width
FP32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, 700 W: where cuFFT runs


def _transform_ops(T: int) -> float:
    n = 2 * T
    return 2.5 * n * math.log2(n)


def hyena_flops(cfg: dict, B: int, T: int, L: int) -> float:
    """One forward of one layer's Hyena operator."""
    C, N, S = cfg["embed_dim"], B * T * L, B * L
    f = 2 * N * C * 3 * C + 2 * N * C * C  # in_proj, out_proj
    f += 2 * 3 * N * 3 * C  # the short convolution
    f += 2 * T * (3 * FILTER_ORDER + 2 * FILTER_ORDER ** 2 + FILTER_ORDER * C)  # the filter
    f += (2 * S * C + C) * _transform_ops(T)  # rfft of the input and the filter, the inverse
    f += 6 * S * C * (T + 1)  # the spectral product, complex
    f += 4 * N * C  # v x1, the bias term and its sum, y x0
    return float(f)


def forward_flops(cfg: dict, B: int, T: int, L: int) -> float:
    """``counting.forward_flops`` with each layer's frame attention (its
    projections and q.k, p.v products) replaced by the Hyena operator."""
    C, nl, N = cfg["embed_dim"], cfg["num_layers"], B * T * L
    attention = 8 * N * C * C + 4 * N * (T + 1) * C
    return counting.forward_flops(cfg, B, T, L) + nl * (hyena_flops(cfg, B, T, L) - attention)


def train_flops(cfg: dict, B: int, T: int, L: int) -> float:
    """Forward and backward: three forwards; recomputation not counted."""
    return 3.0 * forward_flops(cfg, B, T, L)


def fft_work(cfg: dict, B: int, T: int, L: int):
    """(operations, bytes) of the transforms of one ``fftconv`` call and of
    its backward: forward, the filter's and the B L C input channels' real
    transforms and the inputs' inverse; backward, one transform each of
    those three gradients, 2 (2 B L C + C) transforms of n = 2T points in
    all. Each reads or writes T float32 on its real side (the
    zero-padding is not read, the cropped half not kept) and T + 1
    complex64 on its spectral side."""
    C = cfg["embed_dim"]
    transforms = 2 * (2 * B * L * C + C)
    return float(transforms * _transform_ops(T)), float(transforms * (4 * T + 8 * (T + 1)))
