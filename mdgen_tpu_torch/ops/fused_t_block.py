"""Fused frame-attention sublayer (port of ``mdgen_tpu/ops/fused_t_block.py``).

y = x + gate * out_proj(Attn_T(modulate(LN(x), shift, scale))), forward
only (it refuses tensors that require grad): for each (b, l), attention
over the T frames plus the learned bias token at position T. The residue mask is frame-constant: a masked residue
has no valid frame key, so its queries attend to the bias token alone.
CPU tensors take :func:`fused_t_sublayer_plain`; CUDA tensors take the
hand-written kernel ``csrc/fused_t_sublayer.cu`` (three launches on the
tensor cores, or raise; the launch count below counts calls).
"""
from __future__ import annotations

import torch

from ._common import (
    NEG_INF, check_aligned16, check_x, exact_f32, launch, ln_modulate, mm, on_cpu, refuse_grad,
    rnd, rope_tables, rotate_half, same_device, vectors, weights,
)


def fused_t_sublayer_plain(x, shift, scale, gate, mask, qkv_w, qkv_b, bias_k,
                           bias_v, out_w, out_b, *, num_heads: int,
                           use_rope: bool = True, compute_dtype=torch.bfloat16):
    """Plain PyTorch math of the kernel (arguments as ``fused_l_sublayer``).
    Unlike the residue kernel, the Q.K^T, P.V and bias-logit operands are
    rounded to ``compute_dtype`` too, as in the JAX kernel."""
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
        sin, cos = rope_tables(T + 1, hd, torch.float32, x.device)
        s_, c_ = sin[:T, None, None], cos[:T, None, None]  # positions along T
        q = q * c_ + rotate_half(q) * s_
        k = k * c_ + rotate_half(k) * s_
        kb = kb * cos[T] + rotate_half(kb) * sin[T]  # bias token at position T
    q, k, v, kb = rnd(q, dt), rnd(k, dt), rnd(v, dt), rnd(kb, dt)

    s = torch.einsum("bqlhd,bklhd->blhqk", q, k)
    s = torch.where(mask[:, :, None, None, None] > 0, s, NEG_INF)
    lb = torch.einsum("bqlhd,hd->blhq", q, kb)
    m = torch.maximum(s.amax(-1), lb)
    p = torch.exp(s - m[..., None])
    pb = torch.exp(lb - m)
    z = p.sum(-1) + pb  # [B, L, H, T]
    num = torch.einsum("blhqk,bklhd->bqlhd", rnd(p, dt), v)
    num = num + pb.permute(0, 3, 1, 2)[..., None] * vb
    out = (num / z.permute(0, 3, 1, 2)[..., None]).reshape(B, T, L, C)
    o = mm(out, out_w, dt) + out_b.float()
    return x.float() + gate.float()[:, None] * o


def fused_t_sublayer(x, shift, scale, gate, mask, qkv_w, qkv_b, bias_k, bias_v,
                     out_w, out_b, *, num_heads: int, use_rope: bool = True,
                     compute_dtype=torch.bfloat16):
    """See :func:`fused_t_sublayer_plain` for the contract (head dim <= 64)."""
    refuse_grad("fused_t_sublayer", x, shift, scale, gate, mask, qkv_w, qkv_b, bias_k,
                bias_v, out_w, out_b)
    kw = dict(num_heads=num_heads, use_rope=use_rope, compute_dtype=compute_dtype)
    if on_cpu(x):
        return fused_t_sublayer_plain(
            x, shift, scale, gate, mask, qkv_w, qkv_b, bias_k, bias_v, out_w, out_b, **kw
        )
    check_x(x)
    B, T, L, C = x.shape
    H = num_heads
    hd = C // H
    if (hd * H != C or hd % 2 or hd > 64 or C % 8 or qkv_w.shape != (3 * C, C)
            or mask.shape != (B, L)):
        raise ValueError("fused_t_sublayer: unsupported shape")
    same_device(x, shift, scale, gate, mask, qkv_w, qkv_b, bias_k, bias_v, out_w, out_b)
    qkv_wc, out_wc = weights(compute_dtype, qkv_w, out_w)
    check_aligned16(x, qkv_wc, out_wc)
    v_bf16, (sh, sc, g, qb, bk, bv, ob) = vectors(
        shift, scale, gate, qkv_b, bias_k.reshape(-1), bias_v.reshape(-1), out_b
    )
    mask = mask.float().contiguous()
    sin, cos = rope_tables(T + 1, hd, torch.float32, x.device)
    y = torch.empty_like(x)
    # q, k, v in the flash layout, and the attention output [tokens, C]
    qkv = torch.empty((3, B * L * H, T, hd), dtype=compute_dtype, device=x.device)
    ao = torch.empty((B * T * L, C), dtype=compute_dtype, device=x.device)
    if x.numel():
        launch(
            "mdgen_fused_t_sublayer", x.device,
            x.data_ptr(), y.data_ptr(), sh.data_ptr(), sc.data_ptr(), g.data_ptr(),
            mask.data_ptr(), qkv_wc.data_ptr(), qb.data_ptr(), bk.data_ptr(),
            bv.data_ptr(), out_wc.data_ptr(), ob.data_ptr(), sin.data_ptr(),
            cos.data_ptr(), qkv.data_ptr(), ao.data_ptr(), B, T, L, C, H,
            int(use_rope), float(hd**-0.5), int(compute_dtype == torch.bfloat16),
            v_bf16,
        )
        fused_t_sublayer.launches += 1
    return y


fused_t_sublayer.launches = 0
