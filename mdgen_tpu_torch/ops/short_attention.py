"""Attention over a short axis, forward and backward: the residue attention of
``RoPEAttention`` (axis 2 of [B, T, L, C], and the IPA tower's [B, L, C])
with at most ``SHORT_ATTN_MAX_KEYS`` keys, the bias key included.

It reads q, k and v from the packed projection ``qkv`` [B, T, L, 3C] as
``RoPEAttention`` makes it, and keeps its semantics: q scaled by hd**-0.5
before RoPE, ESM rotary tables at positions 0..L-1 and the learned bias key
roped at position L, the bias key and value always attendable, masked keys
filled with ``NEG_INF``, softmax and P.V in f32. Returns o [B, T, L, C].

CPU tensors take :func:`short_attention_plain`, differentiable by autograd.
CUDA tensors take :class:`ShortAttention`: the hand-written kernels of
``csrc/short_attention.cu`` (one launch forward; two backward, whose
gradients of ``bias_k`` and ``bias_v`` are summed in a fixed order), in
float32 only; or raise.
"""
from __future__ import annotations

import torch

from ._common import NEG_INF, exact_f32, launch, on_cpu, refuse_tangent, rope_tables, rotate_half
from .fused_block import FUSED_L_MAX_RESIDUES

# the most keys the kernels take, the bias key included: the residues of the
# fused serving path's gate plus the bias key (``kShortMaxL`` + 1 in
# csrc/short_attention.cu)
SHORT_ATTN_MAX_KEYS = FUSED_L_MAX_RESIDUES + 1
# the widest head they take: one head group of a block, a thread a column
# (``kShortGroupWidth``); a wider head stays on the model's dense route
SHORT_ATTN_MAX_HEAD_DIM = 128
_TILE_TOKENS = 16  # tokens a tile of the kernels: rows of L residues
_MAX_ROW_BLOCKS = 1024  # the backward's row blocks, and so its partial sums


def short_attention_plain(qkv, bias_k, bias_v, mask=None, *, num_heads: int,
                          use_rope: bool = True):
    """Plain PyTorch math of the kernels, in f32. qkv [B, T, L, 3C]; bias_k,
    bias_v of C elements; mask [B, T, L] (1 = valid key) or None."""
    exact_f32()
    B, T, L, C3 = qkv.shape
    C, H = C3 // 3, num_heads
    hd = C // H
    q, k, v = qkv.float().chunk(3, dim=-1)
    q = (q * hd**-0.5).reshape(B, T, L, H, hd)
    k = torch.cat([k.reshape(B, T, L, H, hd),
                   bias_k.float().reshape(1, 1, 1, H, hd).expand(B, T, 1, H, hd)], dim=2)
    v = torch.cat([v.reshape(B, T, L, H, hd),
                   bias_v.float().reshape(1, 1, 1, H, hd).expand(B, T, 1, H, hd)], dim=2)
    if use_rope:
        sin, cos = rope_tables(L + 1, hd, torch.float32, qkv.device)
        sin, cos = sin[:, None], cos[:, None]  # [L + 1, 1, hd]: positions along the L axis
        q = q * cos[:L] + rotate_half(q) * sin[:L]
        k = k * cos + rotate_half(k) * sin
    logits = torch.einsum("btqhd,btkhd->bthqk", q, k)
    if mask is not None:
        keep = torch.cat([mask.float() > 0, torch.ones_like(mask[..., :1], dtype=torch.bool)], -1)
        logits = torch.where(keep[:, :, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bthqk,btkhd->btqhd", probs, v).reshape(B, T, L, C)


def _check(qkv, bias_k, bias_v, mask, num_heads):
    """The kernels' operands: qkv [B, T, L, 3C] f32 with L + 1 <= SHORT_ATTN_MAX_KEYS
    and an even head width up to SHORT_ATTN_MAX_HEAD_DIM; bias_k, bias_v f32
    of C elements; mask [B, T, L] or None; all on qkv's card. Returns (B, T,
    L, C, hd)."""
    if qkv.ndim != 4 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be [B, T, L, 3C], got {tuple(qkv.shape)}")
    B, T, L, C3 = qkv.shape
    C = C3 // 3
    hd = C // num_heads
    if (not 0 < L < SHORT_ATTN_MAX_KEYS or hd * num_heads != C or hd % 2
            or hd > SHORT_ATTN_MAX_HEAD_DIM):
        raise ValueError(f"short_attention takes 1..{SHORT_ATTN_MAX_KEYS - 1} residues and "
                         f"an even head width up to {SHORT_ATTN_MAX_HEAD_DIM}, got L={L}, "
                         f"C={C}, {num_heads} heads")
    for name, t in (("qkv", qkv), ("bias_k", bias_k), ("bias_v", bias_v)):
        if t.dtype != torch.float32:
            raise ValueError(f"short_attention takes float32 operands, got {name} {t.dtype}")
    if bias_k.numel() != C or bias_v.numel() != C:
        raise ValueError(f"bias_k and bias_v must hold C={C} elements")
    if mask is not None and tuple(mask.shape) != (B, T, L):
        raise ValueError(f"mask must be [B, T, L] = {(B, T, L)}, got {tuple(mask.shape)}")
    for t in (bias_k, bias_v) + ((mask,) if mask is not None else ()):
        if t.device != qkv.device:
            raise ValueError(f"all operands must be on {qkv.device}, got {t.device}")
    return B, T, L, C, hd


def _common_args(qkv, mask, num_heads, use_rope):
    """(sin, cos, mask pointer, the shape arguments of both entry points)."""
    B, T, L, C3 = qkv.shape
    hd = C3 // 3 // num_heads
    sin, cos = rope_tables(L + 1, hd, torch.float32, qkv.device)
    if mask is not None:
        mask = mask.float()
        strides = mask.stride()
    else:
        strides = (0, 0, 0)
    rb = max(1, _TILE_TOKENS // L)
    shape = (B * T, T, L, num_heads, hd, rb, *strides, int(use_rope), float(hd**-0.5))
    return sin, cos, mask, shape


def _fwd(qkv, bias_k, bias_v, mask, num_heads, use_rope):
    B, T, L, C, hd = _check(qkv, bias_k, bias_v, mask, num_heads)
    qkv = qkv.contiguous()
    bias_k, bias_v = bias_k.contiguous(), bias_v.contiguous()
    o = torch.empty((B, T, L, C), dtype=torch.float32, device=qkv.device)
    if o.numel():
        sin, cos, mask, shape = _common_args(qkv, mask, num_heads, use_rope)
        launch("mdgen_short_attn_fwd", qkv.device, qkv.data_ptr(),
               mask.data_ptr() if mask is not None else None, bias_k.data_ptr(),
               bias_v.data_ptr(), sin.data_ptr(), cos.data_ptr(), o.data_ptr(), *shape)
        short_attention.launches += 1
    return o


def _bwd(qkv, bias_k, bias_v, mask, do, num_heads, use_rope):
    """(dqkv [B, T, L, 3C], d bias_k [C], d bias_v [C])."""
    B, T, L, C, hd = _check(qkv, bias_k, bias_v, mask, num_heads)
    qkv, do = qkv.contiguous(), do.float().contiguous()
    bias_k, bias_v = bias_k.contiguous(), bias_v.contiguous()
    if do.shape != (B, T, L, C):
        raise ValueError(f"the output's gradient must be {(B, T, L, C)}, got {tuple(do.shape)}")
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((2, C), dtype=torch.float32, device=qkv.device)
    if dqkv.numel():
        sin, cos, mask, shape = _common_args(qkv, mask, num_heads, use_rope)
        tiles = -(-B * T // shape[5])
        n_blocks = min(tiles, _MAX_ROW_BLOCKS)
        partials = torch.empty((n_blocks, 2, C), dtype=torch.float32, device=qkv.device)
        launch("mdgen_short_attn_bwd", qkv.device, qkv.data_ptr(), do.data_ptr(),
               mask.data_ptr() if mask is not None else None, bias_k.data_ptr(),
               bias_v.data_ptr(), sin.data_ptr(), cos.data_ptr(), dqkv.data_ptr(),
               dbias[0].data_ptr(), dbias[1].data_ptr(), partials.data_ptr(), n_blocks, *shape)
        short_attention.launches += 2
    return dqkv, dbias[0], dbias[1]


class ShortAttention(torch.autograd.Function):
    """Forward by ``short_attn_fwd_kernel``, saving only its operands;
    backward by ``short_attn_bwd_kernel`` (dqkv, recomputing the softmax,
    and the bias partials) and ``short_attn_bias_grad_kernel`` (their
    ordered sum)."""

    @staticmethod
    def forward(ctx, qkv, bias_k, bias_v, mask, num_heads, use_rope):
        ctx.save_for_backward(qkv, bias_k, bias_v, mask)
        ctx.num_heads, ctx.use_rope = num_heads, use_rope
        return _fwd(qkv, bias_k, bias_v, mask, num_heads, use_rope)

    @staticmethod
    def backward(ctx, do):
        qkv, bias_k, bias_v, mask = ctx.saved_tensors
        dqkv, dk, dv = _bwd(qkv, bias_k, bias_v, mask, do, ctx.num_heads, ctx.use_rope)
        return dqkv, dk.reshape(bias_k.shape), dv.reshape(bias_v.shape), None, None, None


def short_attention(qkv, bias_k, bias_v, mask=None, *, num_heads: int, use_rope: bool = True):
    """o [B, T, L, C] (see the module's docstring); differentiable in qkv,
    bias_k and bias_v (by autograd; forward-mode AD is refused)."""
    refuse_tangent("short_attention", qkv, bias_k, bias_v)
    if on_cpu(qkv):
        return short_attention_plain(qkv, bias_k, bias_v, mask, num_heads=num_heads,
                                     use_rope=use_rope)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (qkv, bias_k, bias_v)):
        return ShortAttention.apply(qkv, bias_k, bias_v, mask, num_heads, use_rope)
    return _fwd(qkv, bias_k, bias_v, mask, num_heads, use_rope)


short_attention.launches = 0
