"""The Hyena operator's FFT long convolution (``fftconv`` of
``mdgen_tpu/models/hyena.py``): ``torch.fft``, cuFFT on the card, no kernel
of this package. It counts its calls in ``fftconv.launches``, which
``ops.launch_counts`` reports under ``fftconv``.

Kept from the JAX function: the FFT size 2L, ``k_f / fft_size`` with
``irfft(norm="forward")``, the ``[L-1 : 2L-1]`` crop, transforms in f32 and
the result in the input's dtype.
"""
from __future__ import annotations

import torch


def fftconv(u, k, D):
    """u [B, D, L]; k [D, L]; D (the bias) [D] -> [B, D, L] in u.dtype."""
    fftconv.launches += 1
    L = u.shape[-1]
    fft_size = 2 * L
    k_f = torch.fft.rfft(k.float(), n=fft_size) / fft_size
    u_f = torch.fft.rfft(u.float(), n=fft_size)
    y = torch.fft.irfft(u_f * k_f, n=fft_size, norm="forward")[..., L - 1:2 * L - 1]
    return (y + u * D[..., None]).to(u.dtype)


fftconv.launches = 0
