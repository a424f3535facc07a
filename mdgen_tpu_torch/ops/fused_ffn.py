"""Fused MLP sublayer (port of ``mdgen_tpu/ops/fused_ffn.py``).

y = x + gate * fc2(gelu(fc1(modulate(LN(x), shift, scale)))), forward only:
it refuses tensors that require grad. CPU tensors take
:func:`fused_ffn_sublayer_plain`; CUDA tensors take the hand-written kernel
``csrc/fused_ffn.cu`` (two launches on the tensor cores; or raise).
"""
from __future__ import annotations

import torch

from ._common import (
    check_aligned16, check_x, exact_f32, launch, ln_modulate, mm, on_cpu, refuse_grad,
    same_device, vectors, weights,
)


def fused_ffn_sublayer_plain(x, shift, scale, gate, w1, b1, w2, b2, *,
                             compute_dtype=torch.bfloat16):
    """Plain PyTorch math of the kernel. x [B, T, L, C] f32; shift/scale/gate
    [B, 1, C]; w1 [4C, C], b1 [4C], w2 [C, 4C], b2 [C] (nn.Linear layout).
    The fc operands are rounded to ``compute_dtype``; everything else f32."""
    exact_f32()
    dt = compute_dtype
    h = ln_modulate(x, shift, scale)
    h1 = mm(h, w1, dt) + b1.float()
    h1 = 0.5 * h1 * (1.0 + torch.erf(h1 * 2.0**-0.5))
    o = mm(h1, w2, dt) + b2.float()
    return x.float() + gate.float()[:, None] * o


def fused_ffn_sublayer(x, shift, scale, gate, w1, b1, w2, b2, *,
                       compute_dtype=torch.bfloat16):
    """See :func:`fused_ffn_sublayer_plain` for the contract."""
    refuse_grad("fused_ffn_sublayer", x, shift, scale, gate, w1, b1, w2, b2)
    if on_cpu(x):
        return fused_ffn_sublayer_plain(
            x, shift, scale, gate, w1, b1, w2, b2, compute_dtype=compute_dtype
        )
    check_x(x)
    B, T, L, C = x.shape
    Hd = w1.shape[0]
    if w1.shape != (Hd, C) or w2.shape != (C, Hd) or shift.shape != (B, 1, C):
        raise ValueError("fused_ffn_sublayer: shape mismatch")
    if C % 8 or Hd % 8:
        raise ValueError("fused_ffn_sublayer: widths must be multiples of 8")
    same_device(x, shift, scale, gate, w1, b1, w2, b2)
    w1c, w2c = weights(compute_dtype, w1, w2)
    check_aligned16(x, w1c, w2c)
    v_bf16, (sh, sc, g, b1c, b2c) = vectors(shift, scale, gate, b1, b2)
    y = torch.empty_like(x)
    hid = torch.empty((B * T * L, Hd), dtype=compute_dtype, device=x.device)  # gelu(fc1)
    if x.numel():
        launch(
            "mdgen_fused_ffn_sublayer", x.device,
            x.data_ptr(), y.data_ptr(), sh.data_ptr(), sc.data_ptr(), g.data_ptr(),
            w1c.data_ptr(), b1c.data_ptr(), w2c.data_ptr(), b2c.data_ptr(), hid.data_ptr(),
            B * T * L, T * L, C, Hd, int(compute_dtype == torch.bfloat16), v_bf16,
        )
        fused_ffn_sublayer.launches += 1
    return y


fused_ffn_sublayer.launches = 0
