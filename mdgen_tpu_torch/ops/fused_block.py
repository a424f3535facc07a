"""Fused residue-attention sublayer (port of ``mdgen_tpu/ops/fused_block.py``).

y = x + gate * out_proj(Attn_L(modulate(LN(x), shift, scale))), forward
only (it refuses tensors that require grad): attention over the L residues
of each (b, t) row plus the learned bias token. CPU tensors take :func:`fused_l_sublayer_plain`; CUDA tensors take the
hand-written kernel ``csrc/fused_l_sublayer.cu`` (or raise).
"""
from __future__ import annotations

import torch

from ..models.attention import NEG_INF, rotate_half
from . import _build
from ._common import (
    check_x, exact_f32, ln_modulate, mm, on_cpu, refuse_grad, rope_tables, same_device,
    stream_ptr, vectors, weights,
)


def fused_l_sublayer_plain(x, shift, scale, gate, mask, qkv_w, qkv_b, bias_k,
                           bias_v, out_w, out_b, *, num_heads: int,
                           use_rope: bool = True, compute_dtype=torch.bfloat16):
    """Plain PyTorch math of the kernel.

    x [B, T, L, C] f32; shift/scale/gate [B, 1, C]; mask [B, L] (1 = valid
    key); qkv_w [3C, C], qkv_b [3C], bias_k/bias_v [C], out_w [C, C],
    out_b [C] (nn.Linear layout). Only the two projections' operands are
    rounded to ``compute_dtype``; logits, softmax and P.V stay f32.
    """
    exact_f32()
    dt = compute_dtype
    B, T, L, C = x.shape
    H = num_heads
    hd = C // H
    qkv = mm(ln_modulate(x, shift, scale), qkv_w, dt) + qkv_b.float()
    q = (qkv[..., :C] * hd**-0.5).reshape(B, T, L, H, hd)
    k = qkv[..., C:2 * C].reshape(B, T, L, H, hd)
    v = qkv[..., 2 * C:].reshape(B, T, L, H, hd)
    kb = bias_k.float().reshape(H, hd)
    vb = bias_v.float().reshape(H, hd)
    if use_rope:
        sin, cos = rope_tables(L + 1, hd, x.device)
        s_, c_ = sin[:L, None], cos[:L, None]  # positions along the L axis
        q = q * c_ + rotate_half(q) * s_
        k = k * c_ + rotate_half(k) * s_
        kb = kb * cos[L] + rotate_half(kb) * sin[L]  # bias token at position L

    logits = torch.einsum("btqhd,btkhd->bthqk", q, k)
    logits = torch.where(mask[:, None, None, None, :] > 0, logits, NEG_INF)
    lb = torch.einsum("btqhd,hd->bthq", q, kb)
    m = torch.maximum(logits.amax(-1), lb)
    p = torch.exp(logits - m[..., None])
    pb = torch.exp(lb - m)
    z = p.sum(-1) + pb  # [B, T, H, L]
    num = torch.einsum("bthqk,btkhd->btqhd", p, v) + pb.permute(0, 1, 3, 2)[..., None] * vb
    out = (num / z.permute(0, 1, 3, 2)[..., None]).reshape(B, T, L, C)
    o = mm(out, out_w, dt) + out_b.float()
    return x.float() + gate.float()[:, None] * o


def fused_l_sublayer(x, shift, scale, gate, mask, qkv_w, qkv_b, bias_k, bias_v,
                     out_w, out_b, *, num_heads: int, use_rope: bool = True,
                     compute_dtype=torch.bfloat16):
    """See :func:`fused_l_sublayer_plain` for the contract (L <= 16)."""
    refuse_grad("fused_l_sublayer", x, shift, scale, gate, mask, qkv_w, qkv_b, bias_k,
                bias_v, out_w, out_b)
    kw = dict(num_heads=num_heads, use_rope=use_rope, compute_dtype=compute_dtype)
    if on_cpu(x):
        return fused_l_sublayer_plain(
            x, shift, scale, gate, mask, qkv_w, qkv_b, bias_k, bias_v, out_w, out_b, **kw
        )
    check_x(x)
    B, T, L, C = x.shape
    H = num_heads
    hd = C // H
    if L > 16 or hd * H != C or hd % 2 or qkv_w.shape != (3 * C, C) or mask.shape != (B, L):
        raise ValueError("fused_l_sublayer: unsupported shape")
    same_device(x, shift, scale, gate, mask, qkv_w, qkv_b, bias_k, bias_v, out_w, out_b)
    qkv_wc, out_wc = weights(compute_dtype, qkv_w, out_w)
    v_bf16, (sh, sc, g, qb, bk, bv, ob) = vectors(
        shift, scale, gate, qkv_b, bias_k.reshape(-1), bias_v.reshape(-1), out_b
    )
    mask = mask.float().contiguous()
    sin, cos = rope_tables(L + 1, hd, x.device)
    y = torch.empty_like(x)
    if x.numel():
        _build.call(
            "mdgen_fused_l_sublayer",
            x.data_ptr(), y.data_ptr(), sh.data_ptr(), sc.data_ptr(), g.data_ptr(),
            mask.data_ptr(), qkv_wc.data_ptr(), qb.data_ptr(), bk.data_ptr(),
            bv.data_ptr(), out_wc.data_ptr(), ob.data_ptr(), sin.data_ptr(),
            cos.data_ptr(), B, T, L, C, H, int(use_rope), float(hd**-0.5),
            int(compute_dtype == torch.bfloat16), v_bf16, stream_ptr(),
        )
        fused_l_sublayer.launches += 1
    return y


fused_l_sublayer.launches = 0
